// Fused stride-1 conv (forward) and its one-pass backward, channels-last:
//
//   y[b, t, o]  = bias[o] + sum_k sum_i act(x)[b, t - lo + k*dil, i] * w[k, i, o]
//   dx[b, t, i] = (sum_k sum_o g[b, t + lo - k*dil, o] * w[k, i, o])
//                 * where(x[b, t, i] >= 0, 1, slope)        (when act)
//   dw[k, i, o] = sum_{b,t} act(x)[b, t - lo + k*dil, i] * g[b, t, o]
//   db[o]       = sum_{b,t} g[b, t, o]
//
// for K in [2, 5], span = (K-1)*dil <= 64, any lo in [0, span] with
// hi = span - lo (the output as long as the input), zeros outside [0, T).
// act = leaky_relu with the slope rounded to the stream type and the
// product rounded to it, as the TPU kernel's `_leaky` multiplies in the
// stream dtype (the wrapper passes the rounded slope); the backward's mask
// uses the f32 slope on the pre-activation x. f32 and bf16 streams, f32
// sums; dx is rounded once to the stream type.
//
// fused_conv_fwd_* replaces svcc23_fastsvc_tpu/ops/pallas_conv.py _fwd_call
// (_fwd_kernel). It is the window-conv kernel of window_conv.cuh with its
// window started at t0 - lo: the TPU kernel assembles the same
// (left halo | tile | halo) window in VMEM and takes each tap as an
// offset into it. What bounds it on the H100 and its two variants (bf16
// mma.sync on the tensor cores, f32 FFMA) are said in window_conv.cuh.
//
// fused_conv_bwd_* replaces _bwd_call (_bwd_kernel), which reads x and g
// once and accumulates dw and db in f32 VMEM blocks revisited across the
// TPU's sequential grid. Here blocks run in parallel in no order, so the
// sum over the B*T rows is split two ways, deterministically, as the
// window conv's weight gradient splits it (window_conv_grad.cu): block
// (s, slab) takes a fixed range of row tiles (part_begin; the range depends
// on the shapes alone) and, for each tile,
//   1. copies the x window, rows [t0 - lo, t0 + TM + hi) of its input
//      channel slab, and the g window, rows [t0 - hi, t0 + TM + lo), all
//      output channels, into shared memory once (cp.async, zero-filled
//      outside [0, T), stage_rows; the activation applied in place,
//      activate_rows), the next tile's copy in flight while this one
//      computes where two stages fit;
//   2. computes dx for the tile's rows and the slab's channels from the g
//      window and the block's weight slab (the transposed conv: the g
//      window row of tap k for output row r is r + span - k*dil), times the
//      mask from the pre-activation x, rounded once;
//   3. adds the tile's dw sums (the x window against the tile's own g rows,
//      every tap from the one copy) and db into accumulators that stay in
//      registers across the slot's tiles, written once into slot s.
// The ordered slot reduce of window_conv.cuh (slot_reduce_kernel, as the
// weight gradient's) sums the slots. No atomics, so dx, dw and db are the
// same from run to run. Every block loads its weight slab into shared
// memory once, in the layout its dx loop reads. The input channels are cut
// into slabs only where one block cannot hold the weight and the dw
// accumulators of all of them (wide convs, never the generator's training
// convs), and then each slab's blocks read g again.
//
// What bounds it on the H100: the bytes of x, g and dx at the generator's
// 24-channel convs and Cin = 1 (bf16 and f32), the operations (2 * 2*K*Cin*
// Cout a row) at 48 channels and up in f32. A tile is 64 rows, or 256
// where the slab is at most 32 channels wide (the per-tile waits and
// barriers spread over four times the rows). Three variants, chosen by
// ops/fused_conv.py::bwd_plan from dtype and shapes alone:
//
// * mma (bf16, Cin and Cout multiples of 8, Cin >= 16, Cout <= 192): both
//   products on the tensor cores, mma.sync m16n8k16, bf16 operands and f32
//   sums, with #2's fragment loop for dx (A from the g window by ldmatrix,
//   one row address a lane, so a tap is a row shift; B from the weight slab
//   packed as [k][i][o] rows) and #4's for dw (A = act(x)^T and B = the g
//   rows by ldmatrix.trans). For dx the eight warps take 16-row slices (one
//   in each 64 rows) by half the slab's channels, the mask's x values
//   loaded before the products; for dw (tap, 16-channel) pairs by three n8
//   tiles of the output channels. Shared rows are an odd number of 16-byte
//   units (odd_ld).
// * ffma (f32, and bf16 at other widths, widened): the same pass in f32
//   FFMA; dx as 8 channels by up to 4 rows a thread from 128-bit loads of
//   the g window and the weight slab ([k][o][i]); dw as #4's ffma units (a
//   tap, 4 input and 8 output channels a thread, 32 FMAs per three 128-bit
//   loads), spare threads splitting the rows, their sums added in a fixed
//   order at the end.
// * stream (Cin = 1): 256-row tiles; dw and db as one output channel and a
//   share of the rows a thread (K + 1 sums), dx as one row a thread (a dot
//   of K x Cout from the g window and the weight); odd shared rows.

#include "window_conv.cuh"

namespace {

// the variant ids the wrapper passes (ops/fused_conv.py::BWD_VARIANTS)
enum { kBwdMma = 0, kBwdFfma = 1, kBwdStream = 2 };

constexpr int kBwThreads = 256;
constexpr int kBwStreamRows = 256;   // rows of a stream tile: one a thread
constexpr int kBwMaxK = 5;
constexpr int kBwMaxSpan = 64;
constexpr int kBwDwTiles = 3;        // mma dw: n8 tiles of the outputs a warp
constexpr int kBwMmaMaxSlab = 96;    // mma: input channels of a slab
constexpr int kBwMaxOut = 192;       // mma: output channels
constexpr int kBwUnits = 4;          // ffma dw: (tap, 4 in, 8 out) units a thread
constexpr int kBwFfMaxSlab = 128;    // ffma: input channels of a slab
constexpr int kBwDxRows = 4;         // ffma dx: rows a thread
constexpr int kBwRedLd = 33;         // ffma: row-group sums, odd rows
constexpr int kStreamMaxOut = 64;    // stream: output channels

struct BwdArgs {
  const void* x; const void* g; const void* w; void* dx;
  float* part_w; float* part_b;
  int B, T_len, Cin, Cout, K, dil, lo;
  long long swk, swi, swo;
  int has_leaky;
  float act_slope, mask_slope;
  int rows, n_slots, isl, n_islabs, stages;  // the plan (bwd_plan)
};

__device__ __forceinline__ float mask_of(float xv, int has_leaky,
                                         float mask_slope) {
  return has_leaky && !(xv >= 0.f) ? mask_slope : 1.f;
}

// Fill `count` elements of the block's weight slab in shared memory once,
// 16 loads in flight a thread: element i of the walk is dst[d] = w[at]
// where map.at(i, d, at), else 0. The loads are unconditional (from w
// itself where the element is padding) and their values are converted only
// after the whole batch has been issued, so no load waits on another.
template <typename T, typename S, typename Map>
__device__ __forceinline__ void load_slab(int count, const T* w, S* dst,
                                          const Map& map) {
  for (int base = 0; base < count; base += 16 * kBwThreads) {
    T raw[16];
    int d[16];
    bool ok[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int i = base + (int)threadIdx.x + u * kBwThreads;
      long long at = 0;
      d[u] = -1;
      ok[u] = i < count && map.at(i, d[u], at);
      raw[u] = w[ok[u] ? at : 0];
    }
#pragma unroll
    for (int u = 0; u < 16; ++u)
      if (d[u] >= 0) dst[d[u]] = from_f32<S>(ok[u] ? to_f32(raw[u]) : 0.f);
  }
}

// A slab laid out [k][a][b] (b fastest, rows b_ld apart) of the weight's
// (k, i0 + input, output) elements, zeros in the padding. The walk goes
// along b or along a, whichever the weight's strides make contiguous, so
// a warp's loads fall on few lines (a transposed or strided view too).
struct SlabMap {
  int K, na, nb, b_ld, i0, n_in, Cout;
  bool a_is_in;  // [k][input][output] (mma) or [k][output][input] (ffma)
  long long swk, swi, swo;
  __device__ bool at(int i, int& d, long long& off) const {
    const long long sa = a_is_in ? swi : swo, sb = a_is_in ? swo : swi;
    const bool b_fast = (sb < 0 ? -sb : sb) <= (sa < 0 ? -sa : sa);
    int k, aa, bb;
    if (b_fast) {
      bb = i % b_ld;
      const int ka = i / b_ld;
      aa = ka % na;
      k = ka / na;
    } else {
      aa = i % na;
      const int kb = i / na;
      bb = kb % b_ld;
      k = kb / b_ld;
    }
    d = (k * na + aa) * b_ld + bb;
    const int in = a_is_in ? aa : bb, out = a_is_in ? bb : aa;
    if (bb >= nb || in >= n_in || out >= Cout) return false;
    off = k * swk + (i0 + in) * swi + out * swo;
    return true;
  }
};

// ---- mma (bf16) ---------------------------------------------------------

// dw's output tiles: WQ groups of kBwDwTiles n8 tiles (a power of two), the
// eight warps WQ across by 8 / WQ down the (tap, 16-channel) pairs
__host__ __device__ inline int dw_groups(int Cout) {
  int wq = 1;
  while (wq * kBwDwTiles < Cout / 8) wq *= 2;
  return wq;
}

__host__ __device__ inline size_t mma_bwd_smem(int rows, int isl, int Cout,
                                               int K, int span, int stages) {
  const int xld = odd_ld((isl + 15) & ~15), gld = odd_ld((Cout + 15) & ~15);
  return ((size_t)stages * (rows + span) * (xld + gld) +
          (size_t)K * isl * gld) * sizeof(bf16);
}

// TM rows a tile; dx: warp (wm, wn) takes m16 tiles wm + 4mi (mi < TM/64)
// by the n8 tiles [dn0, dn0 + dnn) of the slab, at most NX; dw: PW pairs a
// warp at most.
template <int TM, int NX, int PW>
__global__ void __launch_bounds__(kBwThreads, 1)
fused_bwd_mma_kernel(const __grid_constant__ BwdArgs a) {
  constexpr int MI = TM / 64;
  extern __shared__ __align__(16) unsigned char fb_smem[];
  bf16* smem = reinterpret_cast<bf16*>(fb_smem);
  const int K = a.K, dil = a.dil, lo = a.lo, span = (K - 1) * dil;
  const int hi = span - lo, T_len = a.T_len, Cin = a.Cin, Cout = a.Cout;
  const int slot = blockIdx.x, islab = blockIdx.y;
  const int i0 = islab * a.isl, icn = min(a.isl, Cin - i0);
  const int icpad = (icn + 15) & ~15, gpad = (Cout + 15) & ~15;
  const int xld = odd_ld(icpad), gld = odd_ld(gpad);
  const int wrows = TM + span, stage = wrows * (xld + gld);
  bf16* wsm = smem + a.stages * stage;  // [K][icn] rows of gld: B of dx
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane >> 2, q = lane & 3;
  const bf16* x = static_cast<const bf16*>(a.x);
  const bf16* gg = static_cast<const bf16*>(a.g);
  bf16* dx = static_cast<bf16*>(a.dx);

  const int wm = warp & 3, wn = warp >> 2;
  const int nti = icn / 8, nh = (nti + 1) / 2;
  const int dn0 = wn * nh, dnn = min(nh, nti - dn0);
  const int nto = Cout / 8, WQ = dw_groups(Cout), WP = 8 / WQ;
  const int wq = warp % WQ, wp = warp / WQ;
  const int mcs = icpad / 16, P = K * mcs;
  const bool dw_on = wq * kBwDwTiles < nto;
  int aoff[PW];
#pragma unroll
  for (int jp = 0; jp < PW; ++jp) {
    const int p = wp + WP * jp, k = p / mcs, mc = p - k * mcs;
    // A = act(x)^T: lanes 0-7 rows +0 channels +0, 8-15 rows +0 channels
    // +8, 16-23 rows +8 channels +0, 24-31 rows +8 channels +8
    aoff[jp] = (k * dil + (lane & 7) + (lane >> 4) * 8) * xld + mc * 16 +
               ((lane >> 3) & 1) * 8;
  }
  const int boff = (hi + (lane & 7) + ((lane >> 3) & 1) * 8) * gld +
                   wq * kBwDwTiles * 8;
  const int db_col = tid - (kBwThreads - Cout);
  const bool with_db = islab == 0 && db_col >= 0;

  const int n_tt = (T_len + TM - 1) / TM;
  const long long n_tiles = (long long)a.B * n_tt;
  const long long j0 = part_begin(n_tiles, slot, a.n_slots);
  const long long j1 = part_begin(n_tiles, slot + 1, a.n_slots);

  auto load = [&](long long j, int s) {
    const int b = (int)(j / n_tt), t0 = (int)(j % n_tt) * TM;
    bf16* xs = smem + s * stage;
    bf16* gs = xs + wrows * xld;
    stage_rows<kCopy16, bf16, bf16, kBwThreads>(
        xs, xld, x + (size_t)b * T_len * Cin, t0 - lo, wrows, T_len, Cin, i0,
        icn, icpad, 0, 0.f);
    stage_rows<kCopy16, bf16, bf16, kBwThreads>(
        gs, gld, gg + (size_t)b * T_len * Cout, t0 - hi, wrows, T_len, Cout,
        0, Cout, gpad, 0, 0.f);
    cp_async_commit();
  };

  if (j0 < j1) load(j0, 0);
  // the weight slab, once, as [k][i] rows along o (zeros past Cout)
  load_slab(K * icn * gld, static_cast<const bf16*>(a.w), wsm,
            SlabMap{K, icn, gpad, gld, i0, icn, Cout, true, a.swk, a.swi,
                    a.swo});

  float accw[PW][kBwDwTiles][4];
#pragma unroll
  for (int jp = 0; jp < PW; ++jp)
#pragma unroll
    for (int t = 0; t < kBwDwTiles; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) accw[jp][t][e] = 0.f;
  float bsum = 0.f;

  for (long long j = j0; j < j1; ++j) {
    const int s = a.stages == 2 ? (int)((j - j0) & 1) : 0;
    if (a.stages == 2 && j + 1 < j1) {
      load(j + 1, s ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const int b = (int)(j / n_tt), t0 = (int)(j % n_tt) * TM;
    // the mask's pre-activation x of this thread's dx outputs, in flight
    // while the products run
    __nv_bfloat162 xm[MI][NX][2];
    if (dx != nullptr && a.has_leaky) {
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int nt = 0; nt < NX; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int t = t0 + (wm + 4 * mi) * 16 + g8 + 8 * h;
            const int i = i0 + (dn0 + nt) * 8 + 2 * q;
            xm[mi][nt][h] = nt < dnn && t < T_len
                ? *reinterpret_cast<const __nv_bfloat162*>(
                      x + ((size_t)b * T_len + t) * Cin + i)
                : __floats2bfloat162_rn(0.f, 0.f);
          }
    }
    bf16* xs = smem + s * stage;
    const bf16* gs = xs + wrows * xld;
    if (a.has_leaky)
      activate_rows<kCopy16, bf16, kBwThreads>(xs, xld, t0 - lo, wrows, T_len,
                                               icn, icpad, a.act_slope);
    __syncthreads();
    if (with_db) {
#pragma unroll 8
      for (int r = 0; r < TM; ++r) bsum += to_f32(gs[(hi + r) * gld + db_col]);
    }

    // dx: the g window against the weight slab, tap k's rows shifted by
    // span - k*dil
    if (dx != nullptr && dnn > 0) {
      float accx[MI][NX][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int nt = 0; nt < NX; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) accx[mi][nt][e] = 0.f;
      for (int k = 0; k < K; ++k) {
        const bf16* arow = gs + (wm * 16 + (lane & 15) + span - k * dil) * gld +
                           (lane >> 4) * 8;
        const bf16* wk = wsm + (k * icn + dn0 * 8) * gld + ((lane >> 3) & 1) * 8;
        for (int kc = 0; kc < gpad; kc += 16) {
          uint32_t af[MI][4];
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) ldsm_x4(af[mi], arow + mi * 64 * gld + kc);
#pragma unroll
          for (int nt = 0; nt < NX; nt += 2) {
            if (nt + 1 < dnn) {
              uint32_t r[4];
              ldsm_x4(r, wk + ((nt + (lane >> 4)) * 8 + (lane & 7)) * gld + kc);
#pragma unroll
              for (int mi = 0; mi < MI; ++mi) {
                mma_bf16(accx[mi][nt], af[mi], r[0], r[1]);
                mma_bf16(accx[mi][nt + 1], af[mi], r[2], r[3]);
              }
            } else if (nt < dnn) {
              uint32_t r[2];
              ldsm_x2(r, wk + (nt * 8 + (lane & 7)) * gld + kc);
#pragma unroll
              for (int mi = 0; mi < MI; ++mi)
                mma_bf16(accx[mi][nt], af[mi], r[0], r[1]);
            }
          }
        }
      }
      // accumulator (mi, nt): rows g8 and g8 + 8, channels 2q + {0, 1}
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int nt = 0; nt < NX; ++nt) {
          if (nt >= dnn) break;
          const int i = i0 + (dn0 + nt) * 8 + 2 * q;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int t = t0 + (wm + 4 * mi) * 16 + g8 + 8 * h;
            if (t >= T_len) continue;
            float v0 = accx[mi][nt][2 * h], v1 = accx[mi][nt][2 * h + 1];
            if (a.has_leaky) {
              v0 *= mask_of(__low2float(xm[mi][nt][h]), 1, a.mask_slope);
              v1 *= mask_of(__high2float(xm[mi][nt][h]), 1, a.mask_slope);
            }
            *reinterpret_cast<__nv_bfloat162*>(
                dx + ((size_t)b * T_len + t) * Cin + i) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
    }

    // dw: act(x)^T of the tap-shifted rows against the tile's g rows
    if (dw_on) {
      for (int rs = 0; rs < TM; rs += 16) {
        uint32_t bfr[kBwDwTiles][2];
        {
          uint32_t r[4];
          ldsm_x4_t(r, gs + rs * gld + boff + (lane >> 4) * 8);
          bfr[0][0] = r[0]; bfr[0][1] = r[1];
          bfr[1][0] = r[2]; bfr[1][1] = r[3];
          uint32_t r2[2];
          ldsm_x2_t(r2, gs + rs * gld + boff + 16);
          bfr[2][0] = r2[0]; bfr[2][1] = r2[1];
        }
#pragma unroll
        for (int jp = 0; jp < PW; ++jp) {
          if (wp + WP * jp >= P) break;
          uint32_t af[4];
          ldsm_x4_t(af, xs + rs * xld + aoff[jp]);
#pragma unroll
          for (int t = 0; t < kBwDwTiles; ++t)
            mma_bf16(accw[jp][t], af, bfr[t][0], bfr[t][1]);
        }
      }
    }
    __syncthreads();
    if (a.stages == 1 && j + 1 < j1) load(j + 1, 0);
  }

  // accumulator (pair, t): input channels g8 and g8 + 8 of the pair's 16,
  // output channels 2q + {0, 1} of n8 tile 3wq + t
  float* pw = a.part_w + (size_t)slot * K * Cin * Cout;
  if (dw_on) {
#pragma unroll
    for (int jp = 0; jp < PW; ++jp) {
      const int p = wp + WP * jp;
      if (p >= P) break;
      const int k = p / mcs, mc = p - k * mcs;
#pragma unroll
      for (int t = 0; t < kBwDwTiles; ++t) {
        const int nt = wq * kBwDwTiles + t;
        if (nt >= nto) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = mc * 16 + g8 + 8 * h;
          if (i >= icn) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e)
            pw[((size_t)k * Cin + i0 + i) * Cout + nt * 8 + 2 * q + e] =
                accw[jp][t][2 * h + e];
        }
      }
    }
  }
  if (with_db) a.part_b[(size_t)slot * Cout + db_col] = bsum;
}

// ---- ffma (f32, and bf16 widened) ---------------------------------------

__host__ __device__ inline size_t ffma_bwd_smem(int rows, int isl, int Cout,
                                                int K, int span, int stages) {
  const int icp = (isl + 3) & ~3, ocp = (Cout + 7) & ~7, ic8 = (isl + 7) & ~7;
  size_t area = (size_t)stages * (rows + span) * (icp + 4 + ocp + 4);
  const size_t red = (size_t)kBwThreads * kBwRedLd;
  if (area < red) area = red;
  return (area + (size_t)K * ocp * ic8) * sizeof(float);
}

template <typename T, int TM>
__global__ void __launch_bounds__(kBwThreads, 1)
fused_bwd_ffma_kernel(const __grid_constant__ BwdArgs a) {
  constexpr bool kF32 = sizeof(T) == 4;
  extern __shared__ float4 fb_smem4[];
  float* smem = reinterpret_cast<float*>(fb_smem4);
  const int K = a.K, dil = a.dil, lo = a.lo, span = (K - 1) * dil;
  const int hi = span - lo, T_len = a.T_len, Cin = a.Cin, Cout = a.Cout;
  const int slot = blockIdx.x, islab = blockIdx.y;
  const int i0 = islab * a.isl, icn = min(a.isl, Cin - i0);
  const int icp = (icn + 3) & ~3, ocp = (Cout + 7) & ~7, ic8 = (icn + 7) & ~7;
  const int xld = icp + 4, gld = ocp + 4;
  const int wrows = TM + span, stage = wrows * (xld + gld);
  const int area = max(a.stages * stage, kBwThreads * kBwRedLd);
  float* wsm = smem + area;  // [K][ocp] rows of ic8: dx's weight, i along
  const int tid = threadIdx.x;
  const T* x = static_cast<const T*>(a.x);
  const T* gg = static_cast<const T*>(a.g);
  T* dx = static_cast<T*>(a.dx);
  const bool xvec = Cin % 4 == 0, gvec = Cout % 4 == 0;

  // dx: thread (ty, tx) takes channels 8tx.. and rows ty + TY*m
  const int CO = ic8 / 8, TY = kBwThreads / CO;
  const int tx = tid % CO, ty = tid / CO;
  const bool dx_on = dx != nullptr && ty < TY;
  // dw: units (tap, input quad, output octet); spare threads split the rows
  const int NQ = icp / 4, NO = ocp / 8, n_units = K * NQ * NO;
  const int n_wr = n_units >= kBwThreads ? 1 : kBwThreads / n_units;
  const int wr = n_wr > 1 ? tid / n_units : 0;
  int xo[kBwUnits], go[kBwUnits];
  bool uon[kBwUnits];
#pragma unroll
  for (int v = 0; v < kBwUnits; ++v) {
    const int u = n_wr > 1 ? tid % n_units : tid + kBwThreads * v;
    uon[v] = n_wr > 1 ? (v == 0 && wr < n_wr) : u < n_units;
    const int k = u / (NQ * NO), qq = (u / NO) % NQ, oc = u % NO;
    xo[v] = k * dil * xld + qq * 4;
    go[v] = hi * gld + oc * 8;
  }
  const int db_col = tid - (kBwThreads - Cout);
  const bool with_db = islab == 0 && db_col >= 0;

  const int n_tt = (T_len + TM - 1) / TM;
  const long long n_tiles = (long long)a.B * n_tt;
  const long long j0 = part_begin(n_tiles, slot, a.n_slots);
  const long long j1 = part_begin(n_tiles, slot + 1, a.n_slots);

  auto load = [&](long long j, int s) {
    const int b = (int)(j / n_tt), t0 = (int)(j % n_tt) * TM;
    float* xs = smem + s * stage;
    float* gs = xs + wrows * xld;
    const T* xb = x + (size_t)b * T_len * Cin;
    const T* gb = gg + (size_t)b * T_len * Cout;
    if constexpr (kF32) {
      if (xvec)
        stage_rows<kCopy16, T, float, kBwThreads>(xs, xld, xb, t0 - lo, wrows,
                                                  T_len, Cin, i0, icn, icp, 0, 0.f);
      else
        stage_rows<kCopy4, T, float, kBwThreads>(xs, xld, xb, t0 - lo, wrows,
                                                 T_len, Cin, i0, icn, icp, 0, 0.f);
      if (gvec)
        stage_rows<kCopy16, T, float, kBwThreads>(gs, gld, gb, t0 - hi, wrows,
                                                  T_len, Cout, 0, Cout, ocp, 0, 0.f);
      else
        stage_rows<kCopy4, T, float, kBwThreads>(gs, gld, gb, t0 - hi, wrows,
                                                 T_len, Cout, 0, Cout, ocp, 0, 0.f);
    } else {
      stage_rows<kCopyReg, T, float, kBwThreads>(xs, xld, xb, t0 - lo, wrows,
                                                 T_len, Cin, i0, icn, icp,
                                                 a.has_leaky, a.act_slope);
      stage_rows<kCopyReg, T, float, kBwThreads>(gs, gld, gb, t0 - hi, wrows,
                                                 T_len, Cout, 0, Cout, ocp, 0, 0.f);
    }
    cp_async_commit();
  };

  if (j0 < j1) load(j0, 0);
  // the weight slab, once, as [k][o] rows along i (zeros past Cout and icn)
  load_slab(K * ocp * ic8, static_cast<const T*>(a.w), wsm,
            SlabMap{K, ocp, ic8, ic8, i0, icn, Cout, false, a.swk, a.swi,
                    a.swo});

  float accw[kBwUnits][4][8];
#pragma unroll
  for (int v = 0; v < kBwUnits; ++v)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int o = 0; o < 8; ++o) accw[v][i][o] = 0.f;
  float bsum = 0.f;

  for (long long j = j0; j < j1; ++j) {
    const int s = a.stages == 2 ? (int)((j - j0) & 1) : 0;
    if (a.stages == 2 && j + 1 < j1) {
      load(j + 1, s ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const int b = (int)(j / n_tt), t0 = (int)(j % n_tt) * TM;
    float* xs = smem + s * stage;
    const float* gs = xs + wrows * xld;
    if constexpr (kF32) {
      if (a.has_leaky) {
        if (xvec)
          activate_rows<kCopy16, float, kBwThreads>(xs, xld, t0 - lo, wrows,
                                                    T_len, icn, icp, a.act_slope);
        else
          activate_rows<kCopy4, float, kBwThreads>(xs, xld, t0 - lo, wrows,
                                                   T_len, icn, icp, a.act_slope);
      }
    }
    __syncthreads();
    if (with_db) {
#pragma unroll 8
      for (int r = 0; r < TM; ++r) bsum += gs[(hi + r) * gld + db_col];
    }

    if (dx_on) {
      float accx[kBwDxRows][8];
#pragma unroll
      for (int m = 0; m < kBwDxRows; ++m)
#pragma unroll
        for (int e = 0; e < 8; ++e) accx[m][e] = 0.f;
      for (int k = 0; k < K; ++k) {
        const float* gk = gs + (ty + span - k * dil) * gld;
        const float* wk = wsm + (size_t)k * ocp * ic8 + tx * 8;
        for (int o = 0; o < ocp; o += 4) {
          float4 av[kBwDxRows];
#pragma unroll
          for (int m = 0; m < kBwDxRows; ++m)
            if (ty + TY * m < TM)
              av[m] = *reinterpret_cast<const float4*>(gk + TY * m * gld + o);
#pragma unroll
          for (int oo = 0; oo < 4; ++oo) {
            const float4 w0 = *reinterpret_cast<const float4*>(wk + (o + oo) * ic8);
            const float4 w1 = *reinterpret_cast<const float4*>(wk + (o + oo) * ic8 + 4);
            const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
            for (int m = 0; m < kBwDxRows; ++m) {
              if (ty + TY * m >= TM) continue;
              const float gv = oo == 0 ? av[m].x : oo == 1 ? av[m].y
                             : oo == 2 ? av[m].z : av[m].w;
#pragma unroll
              for (int e = 0; e < 8; ++e) accx[m][e] = fmaf(gv, wv[e], accx[m][e]);
            }
          }
        }
      }
      // a row's eight mask values first, then its outputs: a load after a
      // store to dx would wait for it
#pragma unroll
      for (int m = 0; m < kBwDxRows; ++m) {
        const int t = t0 + ty + TY * m;
        if (ty + TY * m >= TM || t >= T_len) continue;
        const size_t at = ((size_t)b * T_len + t) * Cin + i0 + tx * 8;
        T mk[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) mk[e] = x[at + min(e, icn - 1 - tx * 8)];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (tx * 8 + e < icn)
            dx[at + e] = from_f32<T>(
                accx[m][e] * mask_of(to_f32(mk[e]), a.has_leaky, a.mask_slope));
      }
    }

    // dw: every unit of this thread over its rows of the tile
#pragma unroll 2
    for (int r = wr; r < TM; r += n_wr) {
#pragma unroll
      for (int v = 0; v < kBwUnits; ++v) {
        if (!uon[v]) continue;
        const float4 av = *reinterpret_cast<const float4*>(xs + r * xld + xo[v]);
        const float4 g0 = *reinterpret_cast<const float4*>(gs + r * gld + go[v]);
        const float4 g1 = *reinterpret_cast<const float4*>(gs + r * gld + go[v] + 4);
        const float xv[4] = {av.x, av.y, av.z, av.w};
        const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int o = 0; o < 8; ++o) accw[v][i][o] = fmaf(xv[i], gv[o], accw[v][i][o]);
      }
    }
    __syncthreads();
    if (a.stages == 1 && j + 1 < j1) load(j + 1, 0);
  }

  // the row groups' sums, added in group order (the stages are free now)
  float* pw = a.part_w + (size_t)slot * K * Cin * Cout;
  if (n_wr > 1) {
    float* red = smem;
    if (uon[0])
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int o = 0; o < 8; ++o)
          red[(wr * n_units + tid % n_units) * kBwRedLd + i * 8 + o] = accw[0][i][o];
    __syncthreads();
    if (wr == 0 && tid < n_units)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int o = 0; o < 8; ++o) {
          float v = 0.f;
          for (int rr = 0; rr < n_wr; ++rr) v += red[(rr * n_units + tid) * kBwRedLd + i * 8 + o];
          accw[0][i][o] = v;
        }
  }
#pragma unroll
  for (int v = 0; v < kBwUnits; ++v) {
    if (!uon[v] || wr != 0) continue;
    const int u = n_wr > 1 ? tid : tid + kBwThreads * v;
    const int k = u / (NQ * NO), qq = (u / NO) % NQ, oc = u % NO;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ci = qq * 4 + i;
      if (ci >= icn) continue;
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        const int co = oc * 8 + o;
        if (co < Cout) pw[((size_t)k * Cin + i0 + ci) * Cout + co] = accw[v][i][o];
      }
    }
  }
  if (with_db) a.part_b[(size_t)slot * Cout + db_col] = bsum;
}

// ---- stream (Cin = 1) ---------------------------------------------------

__host__ __device__ inline size_t stream_bwd_smem(int Cout, int K, int span) {
  return ((size_t)2 * (kBwStreamRows + span) * (Cout + 2) + (size_t)K * Cout +
          (size_t)kBwThreads * (K + 1)) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kBwThreads)
fused_bwd_stream_kernel(const __grid_constant__ BwdArgs a) {
  constexpr bool kF32 = sizeof(T) == 4;
  extern __shared__ float4 fb_smem4[];
  float* smem = reinterpret_cast<float*>(fb_smem4);
  const int K = a.K, dil = a.dil, lo = a.lo, span = (K - 1) * dil;
  const int hi = span - lo, T_len = a.T_len, Cout = a.Cout;
  const int gld = Cout + 1;  // odd: a row per lane hits distinct banks
  const int wrows = kBwStreamRows + span, stage = wrows * (1 + gld);
  float* wsm = smem + 2 * stage;  // [K][Cout]
  float* red = wsm + K * Cout;    // [thread][K + 1]
  const int tid = threadIdx.x, slot = blockIdx.x;
  const T* x = static_cast<const T*>(a.x);
  const T* gg = static_cast<const T*>(a.g);
  T* dx = static_cast<T*>(a.dx);
  // dw and db: output channel o, rows rg, rg + n_rg, ... of each tile
  const int n_rg = kBwThreads / Cout, rg = tid / Cout, o = tid % Cout;
  const bool dw_on = rg < n_rg;

  const int n_tt = (T_len + kBwStreamRows - 1) / kBwStreamRows;
  const long long n_tiles = (long long)a.B * n_tt;
  const long long j0 = part_begin(n_tiles, slot, a.n_slots);
  const long long j1 = part_begin(n_tiles, slot + 1, a.n_slots);

  auto load = [&](long long j, int s) {
    const int b = (int)(j / n_tt), t0 = (int)(j % n_tt) * kBwStreamRows;
    float* xs = smem + s * stage;
    float* gs = xs + wrows;
    const T* xb = x + (size_t)b * T_len;
    const T* gb = gg + (size_t)b * T_len * Cout;
    if constexpr (kF32) {
      stage_rows<kCopy4, T, float, kBwThreads>(xs, 1, xb, t0 - lo, wrows, T_len,
                                               1, 0, 1, 1, 0, 0.f);
      stage_rows<kCopy4, T, float, kBwThreads>(gs, gld, gb, t0 - hi, wrows, T_len,
                                               Cout, 0, Cout, Cout, 0, 0.f);
    } else {
      stage_rows<kCopyReg, T, float, kBwThreads>(xs, 1, xb, t0 - lo, wrows, T_len,
                                                 1, 0, 1, 1, a.has_leaky,
                                                 a.act_slope);
      stage_rows<kCopyReg, T, float, kBwThreads>(gs, gld, gb, t0 - hi, wrows,
                                                 T_len, Cout, 0, Cout, Cout, 0, 0.f);
    }
    cp_async_commit();
  };

  if (j0 < j1) load(j0, 0);
  const T* w = static_cast<const T*>(a.w);
  for (int idx = tid; idx < K * Cout; idx += kBwThreads) {
    const int k = idx / Cout, oo = idx - k * Cout;
    wsm[idx] = to_f32(w[k * a.swk + oo * a.swo]);
  }

  float acc[kBwMaxK];
#pragma unroll
  for (int k = 0; k < kBwMaxK; ++k) acc[k] = 0.f;
  float bsum = 0.f;

  for (long long j = j0; j < j1; ++j) {
    const int s = (int)((j - j0) & 1);
    if (j + 1 < j1) {
      load(j + 1, s ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const int b = (int)(j / n_tt), t0 = (int)(j % n_tt) * kBwStreamRows;
    float* xs = smem + s * stage;
    const float* gs = xs + wrows;
    if constexpr (kF32) {
      if (a.has_leaky)
        activate_rows<kCopy4, float, kBwThreads>(xs, 1, t0 - lo, wrows, T_len,
                                                 1, 1, a.act_slope);
    }
    __syncthreads();
    if (dw_on)
      for (int r = rg; r < kBwStreamRows; r += n_rg) {
        const float gv = gs[(hi + r) * gld + o];
#pragma unroll
        for (int k = 0; k < kBwMaxK; ++k)
          if (k < K) acc[k] = fmaf(xs[r + k * dil], gv, acc[k]);
        bsum += gv;
      }
    const int t = t0 + tid;
    if (dx != nullptr && t < T_len) {
      float v = 0.f;
      for (int k = 0; k < K; ++k) {
        const float* gr = gs + (tid + span - k * dil) * gld;
        const float* wk = wsm + k * Cout;
        for (int oo = 0; oo < Cout; ++oo) v = fmaf(gr[oo], wk[oo], v);
      }
      const size_t at = (size_t)b * T_len + t;
      dx[at] = from_f32<T>(v * mask_of(to_f32(x[at]), a.has_leaky, a.mask_slope));
    }
    __syncthreads();
  }

  // each thread's K + 1 sums, then one thread per (k, o) adds the row
  // groups in order
#pragma unroll
  for (int k = 0; k < kBwMaxK; ++k)
    if (k < K) red[tid * (K + 1) + k] = acc[k];
  red[tid * (K + 1) + K] = bsum;
  __syncthreads();
  for (int idx = tid; idx < (K + 1) * Cout; idx += kBwThreads) {
    const int k = idx / Cout, oo = idx - k * Cout;
    float v = 0.f;
    for (int r = 0; r < n_rg; ++r) v += red[(r * Cout + oo) * (K + 1) + k];
    if (k < K) a.part_w[((size_t)slot * K + k) * Cout + oo] = v;
    else a.part_b[(size_t)slot * Cout + oo] = v;
  }
}

// ---- launches ----------------------------------------------------------

template <typename Kern>
int bwd_smem(Kern kern, size_t smem) {
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int TM, int NX, int PW>
int launch_bwd_mma(const BwdArgs& a, cudaStream_t s) {
  const int span = (a.K - 1) * a.dil;
  const int WP = 8 / dw_groups(a.Cout);
  if (a.Cin % 8 || a.Cin < 16 || a.Cout % 8 || a.Cout > kBwMaxOut ||
      a.isl % 16 || a.isl > kBwMmaMaxSlab || (a.isl / 8 + 1) / 2 > NX ||
      a.K * (a.isl / 16) > WP * PW)
    return (int)cudaErrorInvalidValue;
  const size_t smem = mma_bwd_smem(TM, a.isl, a.Cout, a.K, span, a.stages);
  auto kern = fused_bwd_mma_kernel<TM, NX, PW>;
  if (int e = bwd_smem(kern, smem)) return e;
  kern<<<dim3(a.n_slots, a.n_islabs), kBwThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int TM>
int launch_bwd_ffma(const BwdArgs& a, cudaStream_t s) {
  const int span = (a.K - 1) * a.dil;
  if (a.isl % 8 || a.isl > kBwFfMaxSlab ||
      a.K * (a.isl / 4) * ((a.Cout + 7) / 8) > kBwUnits * kBwThreads ||
      kBwThreads / (a.isl / 8) * kBwDxRows < TM)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ffma_bwd_smem(TM, a.isl, a.Cout, a.K, span, a.stages);
  auto kern = fused_bwd_ffma_kernel<T, TM>;
  if (int e = bwd_smem(kern, smem)) return e;
  kern<<<dim3(a.n_slots, a.n_islabs), kBwThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_stream(const BwdArgs& a, cudaStream_t s) {
  if (a.Cin != 1 || a.Cout > kStreamMaxOut || a.isl != 1 || a.stages != 2)
    return (int)cudaErrorInvalidValue;
  const size_t smem = stream_bwd_smem(a.Cout, a.K, (a.K - 1) * a.dil);
  auto kern = fused_bwd_stream_kernel<T>;
  if (int e = bwd_smem(kern, smem)) return e;
  kern<<<a.n_slots, kBwThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// The plan names the variant and its tile rows (ops/fused_conv.py::
// bwd_plan); a plan that matches no instance here is refused with
// cudaErrorInvalidValue before any launch. Then the ordered slot reduce.
template <typename T>
int fused_bwd(const BwdArgs& a, int variant, void* dw, void* db,
              cudaStream_t s) {
  if (a.K < 2 || a.K > kBwMaxK || a.dil < 1 || (a.K - 1) * a.dil > kBwMaxSpan ||
      a.lo < 0 || a.lo > (a.K - 1) * a.dil || a.B < 1 || a.T_len < 1 ||
      a.n_slots < 1 || a.isl < 1 || a.stages < 1 || a.stages > 2 ||
      a.n_islabs != (a.Cin + a.isl - 1) / a.isl)
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 2) {
    if (variant == kBwdMma && a.rows == 64) err = launch_bwd_mma<64, 6, 9>(a, s);
    if (variant == kBwdMma && a.rows == 256) err = launch_bwd_mma<256, 2, 3>(a, s);
  }
  if (variant == kBwdFfma && a.rows == 64) err = launch_bwd_ffma<T, 64>(a, s);
  if (variant == kBwdFfma && a.rows == 256) err = launch_bwd_ffma<T, 256>(a, s);
  if (variant == kBwdStream && a.rows == 256) err = launch_bwd_stream<T>(a, s);
  if (err != 0) return err;
  return launch_slot_reduce(a.part_w, a.part_b, static_cast<float*>(dw),
                            static_cast<float*>(db),
                            (long long)a.K * a.Cin * a.Cout, a.Cout,
                            a.n_slots, s);
}

}  // namespace

// x (B, T, Cin) and y (B, T, Cout) contiguous; w (K, Cin, Cout) addressed by
// the element strides swk, swi, swo; bias (Cout,) or null; slope already
// rounded to the stream type. variant, tm and tn are the caller's plan
// (ops/window_conv.py::fwd_plan), as for the window conv.
extern "C" int fused_conv_fwd_f32(const void* x, const void* w, const void* b,
                                  void* y, void* wpack, int B, int T_len, int Cin, int Cout,
                                  int K, int dil, int lo, long long swk,
                                  long long swi, long long swo, int has_leaky,
                                  float slope, int variant, int tm, int tn,
                                  void* stream) {
  const ConvArgs a{x, w, b, nullptr, y, wpack, B, T_len, Cin, Cout, K, dil, lo,
                   swk, swi, swo, has_leaky, slope, 0.f,
                   static_cast<cudaStream_t>(stream)};
  return dispatch_window_conv<float, 2>(a, variant, tm, tn);
}

extern "C" int fused_conv_fwd_bf16(const void* x, const void* w,
                                   const void* b, void* y, void* wpack, int B, int T_len,
                                   int Cin, int Cout, int K, int dil, int lo,
                                   long long swk, long long swi, long long swo,
                                   int has_leaky, float slope, int variant,
                                   int tm, int tn, void* stream) {
  const ConvArgs a{x, w, b, nullptr, y, wpack, B, T_len, Cin, Cout, K, dil, lo,
                   swk, swi, swo, has_leaky, slope, 0.f,
                   static_cast<cudaStream_t>(stream)};
  return dispatch_window_conv<bf16, 2>(a, variant, tm, tn);
}

// x (B, T, Cin) the forward's pre-activation input and g (B, T, Cout), both
// contiguous; w as in the forward; dx (B, T, Cin) out, or null to skip it;
// part_w (n_slots, K, Cin, Cout) and part_b (n_slots, Cout) f32 scratch; dw
// (K, Cin, Cout) and db (Cout,) f32 out. act_slope is the forward's
// (rounded) slope, mask_slope the f32 one. variant, rows, n_slots, isl,
// n_islabs and stages are the caller's plan (ops/fused_conv.py::bwd_plan).
#define FUSED_BWD_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const void* x, const void* g, const void* w, void* dx,   \
                      void* part_w, void* part_b, void* dw, void* db, int B,   \
                      int T_len, int Cin, int Cout, int K, int dil, int lo,    \
                      long long swk, long long swi, long long swo,             \
                      int has_leaky, float act_slope, float mask_slope,        \
                      int variant, int rows, int n_slots, int isl,             \
                      int n_islabs, int stages, void* stream) {                \
    const BwdArgs a{x, g, w, dx, static_cast<float*>(part_w),                  \
                    static_cast<float*>(part_b), B, T_len, Cin, Cout, K, dil,  \
                    lo, swk, swi, swo, has_leaky, act_slope, mask_slope, rows, \
                    n_slots, isl, n_islabs, stages};                           \
    return fused_bwd<T>(a, variant, dw, db,                                    \
                        static_cast<cudaStream_t>(stream));                    \
  }

FUSED_BWD_ENTRY(fused_conv_bwd_f32, float)
FUSED_BWD_ENTRY(fused_conv_bwd_bf16, bf16)
