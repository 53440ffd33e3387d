// Backward of the window conv (window_conv.cuh), channels-last:
//
//   dx_c[b, t, i] = sum_k sum_o g[b, t - lo + k*dil, o] * w[K-1-k, i, o]
//   dx = dx_c * where(x >= 0, 1, slope)       (when the forward had act)
//   dw[k, i, o]   = sum_{b,t} act(x)[b, t - lo + k*dil, i] * g[b, t, o]
//   db[o]         = sum_{b,t} g[b, t, o]
//
// dx replaces svcc23_fastsvc_tpu/ops/pallas_window_conv.py window_conv_dx,
// which reuses the forward kernel on g with the weight reversed in K and
// transposed. So does this one: window_conv_dx_* is the forward template
// (both its variants) with the weight read through a negative K stride and
// swapped channel strides, and the leaky-relu derivative of x applied in
// its epilogue (in f32, after rounding to the storage type, as the JAX
// package does it outside).
//
// wgrad replaces window_conv_wgrad (_wgrad_kernel), which sums dw and db in
// f32 VMEM scratch across the TPU's sequential grid, reading x and g once.
// What bounds it on the H100: the bytes of x and g at the generator's 24-
// and 48-channel convs and at Cin = 1 (a byte bound of 0.008-0.03 ms at
// the recipe's batch), the operations at 96 channels and up in f32. So a
// block reads each row of x and g once per channel slab and computes every
// tap from that copy, where a block per tap would read x K times:
//
// * Partial pass. Block (s, slab) owns a fixed, contiguous range of row
//   tiles (R rows of one utterance each; the range depends on the shapes
//   alone) and one slab of input and output channels. It stages each
//   tile's activated x window [t0 - lo, t0 + R + span - lo) and its g tile
//   [t0, t0 + R) once, by cp.async in two stages (the next tile's copy
//   overlaps this tile's products), and from that one copy computes the
//   partial sums of all K taps of its slab, which it writes to slot s.
//   - mma (bf16, Cin a multiple of 8 and at least 16, Cout a multiple of 8):
//     mma.sync m16n8k16 with A = act(x)^T of the tap-shifted rows (M = Cin,
//     depth = rows, ldmatrix.trans) and B = the g tile (N = Cout), f32
//     accumulators; each warp holds up to three (tap, 16-channel) pairs by
//     all the slab's output tiles.
//   - ffma (f32, and bf16 at other widths): each thread holds a (tap, 4
//     input, 8 output channels) tile, 32 FMAs per three 128-bit shared
//     loads, the rows split among spare threads and summed in a fixed order.
//   - stream (Cin = 1): 256 threads walk the rows with 16-byte loads of g,
//     K x 8 (bf16) or K x 4 (f32) accumulators each, then a block reduction
//     in thread order. No padded input tile.
// * Reduce pass (window_conv.cuh's slot_reduce_kernel, which the fused
//   conv's backward shares): the slots summed in a fixed order, up to 32
//   slot groups to an element, then the groups in order.
// No atomics, so dw and db are the same from run to run. db comes from the
// staged g tiles of the first input slab. The activated input is rounded to
// the storage type before the product, as the TPU kernel stores it back into
// its window, and rows past T contribute zero. ops/window_conv.py::
// wgrad_plan chooses the variant, R, the slabs and the slot count, and the
// entry checks the plan against the instances compiled here.

#include "window_conv.cuh"

namespace {

constexpr int kWgThreads = 256;
constexpr int kFfOcs = 32;      // ffma: output channels per slab
constexpr int kStreamKMax = 7;  // stream: most taps

// the variant ids the callers pass (ops/window_conv.py::WGRAD_VARIANTS)
enum { kWgMma = 0, kWgFfma = 1, kWgStream = 2 };

template <int NTB, int PPW>
__global__ void __launch_bounds__(kWgThreads, NTB * PPW <= 12 ? 3 : 2)
wgrad_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                 float* __restrict__ part_w, float* __restrict__ part_b,
                 int B, int T_len, int Cin, int Cout, int K, int dil,
                 int has_leaky, float slope, int rows, int n_slots, int ics,
                 int n_oslabs) {
  constexpr int OCS = NTB * 8;
  constexpr int kGLd = odd_ld(OCS);
  extern __shared__ __align__(16) unsigned char wg_smem[];
  bf16* smem = reinterpret_cast<bf16*>(wg_smem);
  const int lo = (K - 1) / 2 * dil, span = (K - 1) * dil;
  const int slot = blockIdx.x;
  const int islab = blockIdx.y / n_oslabs, oslab = blockIdx.y % n_oslabs;
  const int i0 = islab * ics, icn = min(ics, Cin - i0);
  const int icpad = (icn + 15) & ~15;
  const int o0 = oslab * OCS, ocn = min(OCS, Cout - o0);
  const int xld = odd_ld(ics);
  const int xrows = rows + span;
  const int stage = xrows * xld + rows * kGLd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mts = icpad / 16;
  const int n_pairs = K * mts;
  // db on the last threads, whose warps hold the fewest (tap, channel) pairs
  const int db_col = (int)threadIdx.x - (kWgThreads - ocn);
  const bool with_db = islab == 0 && db_col >= 0;

  const int n_tt = (T_len + rows - 1) / rows;
  const long long n_tiles = (long long)B * n_tt;
  const long long j0 = part_begin(n_tiles, slot, n_slots);
  const long long j1 = part_begin(n_tiles, slot + 1, n_slots);

  float acc[PPW][NTB][4];
#pragma unroll
  for (int p = 0; p < PPW; ++p)
#pragma unroll
    for (int nt = 0; nt < NTB; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][nt][e] = 0.f;
  float bsum = 0.f;

  auto load = [&](long long j, int s) {
    const int b = (int)(j / n_tt), t0 = (int)(j % n_tt) * rows;
    bf16* xs = smem + s * stage;
    bf16* gs = xs + xrows * xld;
    stage_rows<kCopy16, bf16, bf16, kWgThreads>(
        xs, xld, x + (size_t)b * T_len * Cin, t0 - lo, xrows, T_len, Cin, i0,
        icn, icpad, 0, 0.f);
    stage_rows<kCopy16, bf16, bf16, kWgThreads>(
        gs, kGLd, g + (size_t)b * T_len * Cout, t0, rows, T_len, Cout, o0, ocn,
        OCS, 0, 0.f);
    cp_async_commit();
  };

  if (j0 < j1) load(j0, 0);
  for (long long j = j0; j < j1; ++j) {
    const int s = (int)((j - j0) & 1);
    if (j + 1 < j1) {
      load(j + 1, s ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    bf16* xs = smem + s * stage;
    const bf16* gs = xs + xrows * xld;
    if (has_leaky) {
      const int t0 = (int)(j % n_tt) * rows;
      activate_rows<kCopy16, bf16, kWgThreads>(xs, xld, t0 - lo, xrows, T_len,
                                               icn, icpad, slope);
    }
    __syncthreads();
    if (with_db)
      for (int r = 0; r < rows; ++r) bsum += to_f32(gs[r * kGLd + db_col]);
    for (int rs = 0; rs < rows; rs += 16) {
      // B: g rows rs..rs+15 by the slab's n8 tiles (transposed loads)
      uint32_t bfr[NTB][2];
#pragma unroll
      for (int nt = 0; nt + 1 < NTB; nt += 2) {
        uint32_t r[4];
        ldsm_x4_t(r, gs + (rs + (lane & 7) + ((lane >> 3) & 1) * 8) * kGLd +
                         (nt + (lane >> 4)) * 8);
        bfr[nt][0] = r[0]; bfr[nt][1] = r[1];
        bfr[nt + 1][0] = r[2]; bfr[nt + 1][1] = r[3];
      }
      if constexpr (NTB % 2 == 1) {
        uint32_t r[2];
        ldsm_x2_t(r, gs + (rs + (lane & 7) + ((lane >> 3) & 1) * 8) * kGLd +
                         (NTB - 1) * 8);
        bfr[NTB - 1][0] = r[0]; bfr[NTB - 1][1] = r[1];
      }
#pragma unroll
      for (int jp = 0; jp < PPW; ++jp) {
        const int p = warp + 8 * jp;
        if (p >= n_pairs) break;
        const int k = p / mts, mt = p - k * mts;
        // A = act(x)^T: lanes 0-7 rows +0 channels +0, 8-15 rows +0
        // channels +8, 16-23 rows +8 channels +0, 24-31 rows +8 channels +8
        uint32_t a[4];
        ldsm_x4_t(a, xs + (rs + k * dil + (lane & 7) + (lane >> 4) * 8) * xld +
                         mt * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int nt = 0; nt < NTB; ++nt)
          mma_bf16(acc[jp][nt], a, bfr[nt][0], bfr[nt][1]);
      }
    }
    __syncthreads();
  }

  // accumulator (pair, nt): input channels lane/4 and lane/4 + 8 of the
  // pair's 16, output channels 2*(lane%4) + {0, 1} of the tile's 8
  float* pw = part_w + (size_t)slot * K * Cin * Cout;
#pragma unroll
  for (int jp = 0; jp < PPW; ++jp) {
    const int p = warp + 8 * jp;
    if (p >= n_pairs) break;
    const int k = p / mts, mt = p - k * mts;
#pragma unroll
    for (int nt = 0; nt < NTB; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = i0 + mt * 16 + (lane >> 2) + 8 * h;
          const int o = o0 + nt * 8 + (lane & 3) * 2 + e;
          if (i < i0 + icn && o < o0 + ocn)
            pw[((size_t)k * Cin + i) * Cout + o] = acc[jp][nt][2 * h + e];
        }
  }
  if (with_db) part_b[(size_t)slot * Cout + o0 + db_col] = bsum;
}

template <typename T>
__global__ void __launch_bounds__(kWgThreads, 3)
wgrad_ffma_kernel(const T* __restrict__ x, const T* __restrict__ g,
                  float* __restrict__ part_w, float* __restrict__ part_b,
                  int B, int T_len, int Cin, int Cout, int K, int dil,
                  int has_leaky, float slope, int rows, int n_slots, int ics,
                  int n_oslabs) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kGLd = kFfOcs + 4;
  constexpr int kRedLd = 33;
  extern __shared__ float4 wg_smem4[];
  float* smem = reinterpret_cast<float*>(wg_smem4);
  const int lo = (K - 1) / 2 * dil, span = (K - 1) * dil;
  const int slot = blockIdx.x;
  const int islab = blockIdx.y / n_oslabs, oslab = blockIdx.y % n_oslabs;
  const int i0 = islab * ics, icn = min(ics, Cin - i0);
  const int icpad = (icn + 3) & ~3;
  const int o0 = oslab * kFfOcs, ocn = min(kFfOcs, Cout - o0);
  const int ocpad = (ocn + 7) & ~7;
  const int xld = ics + 4;
  const int xrows = rows + span;
  const int stage = xrows * xld + rows * kGLd;
  const bool xvec = Cin % 4 == 0, gvec = Cout % 4 == 0;

  // units (tap, input quad, output octet); spare threads split the rows
  const int n_q = icpad / 4, n_o = ocpad / 8;
  const int n_units = K * n_q * n_o;
  const int n_wr = max(1, kWgThreads / n_units);
  const int u = threadIdx.x % n_units, wr = threadIdx.x / n_units;
  const bool active = wr < n_wr;
  const int k = u / (n_q * n_o), q = (u / n_o) % n_q, oc = u % n_o;
  // db on the last threads, idle or in the last row group
  const int db_col = (int)threadIdx.x - (kWgThreads - ocn);
  const bool with_db = islab == 0 && db_col >= 0;

  const int n_tt = (T_len + rows - 1) / rows;
  const long long n_tiles = (long long)B * n_tt;
  const long long j0 = part_begin(n_tiles, slot, n_slots);
  const long long j1 = part_begin(n_tiles, slot + 1, n_slots);

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int o = 0; o < 8; ++o) acc[i][o] = 0.f;
  float bsum = 0.f;

  auto load = [&](long long j, int s) {
    const int b = (int)(j / n_tt), t0 = (int)(j % n_tt) * rows;
    float* xs = smem + s * stage;
    float* gs = xs + xrows * xld;
    const T* xb = x + (size_t)b * T_len * Cin;
    const T* gb = g + (size_t)b * T_len * Cout;
    if constexpr (kF32) {
      if (xvec)
        stage_rows<kCopy16, T, float, kWgThreads>(xs, xld, xb, t0 - lo, xrows,
                                                  T_len, Cin, i0, icn, icpad, 0, 0.f);
      else
        stage_rows<kCopy4, T, float, kWgThreads>(xs, xld, xb, t0 - lo, xrows,
                                                 T_len, Cin, i0, icn, icpad, 0, 0.f);
      if (gvec)
        stage_rows<kCopy16, T, float, kWgThreads>(gs, kGLd, gb, t0, rows, T_len,
                                                  Cout, o0, ocn, ocpad, 0, 0.f);
      else
        stage_rows<kCopy4, T, float, kWgThreads>(gs, kGLd, gb, t0, rows, T_len,
                                                 Cout, o0, ocn, ocpad, 0, 0.f);
    } else {
      stage_rows<kCopyReg, T, float, kWgThreads>(xs, xld, xb, t0 - lo, xrows,
                                                 T_len, Cin, i0, icn, icpad,
                                                 has_leaky, slope);
      stage_rows<kCopyReg, T, float, kWgThreads>(gs, kGLd, gb, t0, rows, T_len,
                                                 Cout, o0, ocn, ocpad, 0, 0.f);
    }
    cp_async_commit();
  };

  if (j0 < j1) load(j0, 0);
  for (long long j = j0; j < j1; ++j) {
    const int s = (int)((j - j0) & 1);
    if (j + 1 < j1) {
      load(j + 1, s ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    float* xs = smem + s * stage;
    const float* gs = xs + xrows * xld;
    if constexpr (kF32) {
      if (has_leaky) {
        const int t0 = (int)(j % n_tt) * rows;
        if (xvec)
          activate_rows<kCopy16, float, kWgThreads>(xs, xld, t0 - lo, xrows,
                                                    T_len, icn, icpad, slope);
        else
          activate_rows<kCopy4, float, kWgThreads>(xs, xld, t0 - lo, xrows,
                                                   T_len, icn, icpad, slope);
      }
    }
    __syncthreads();
    if (with_db)
      for (int r = 0; r < rows; ++r) bsum += gs[r * kGLd + db_col];
    if (active) {
      const float* xk = xs + k * dil * xld + q * 4;
      const float* go = gs + oc * 8;
      for (int r = wr; r < rows; r += n_wr) {
        const float4 a = *reinterpret_cast<const float4*>(xk + r * xld);
        const float4 g0 = *reinterpret_cast<const float4*>(go + r * kGLd);
        const float4 g1 = *reinterpret_cast<const float4*>(go + r * kGLd + 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int o = 0; o < 8; ++o) acc[i][o] = fmaf(av[i], gv[o], acc[i][o]);
      }
    }
    __syncthreads();
  }

  // the row groups' sums, added in group order (the stages are free now)
  float* red = smem;
  if (active)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int o = 0; o < 8; ++o)
        red[(wr * n_units + u) * kRedLd + i * 8 + o] = acc[i][o];
  __syncthreads();
  if (active && wr == 0) {
    float* pw = part_w + (size_t)slot * K * Cin * Cout;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        float v = 0.f;
        for (int r = 0; r < n_wr; ++r) v += red[(r * n_units + u) * kRedLd + i * 8 + o];
        const int ci = i0 + q * 4 + i, co = o0 + oc * 8 + o;
        if (ci < i0 + icn && co < o0 + ocn)
          pw[((size_t)k * Cin + ci) * Cout + co] = v;
      }
  }
  if (with_db) part_b[(size_t)slot * Cout + o0 + db_col] = bsum;
}

// Cin = 1: thread tid < S = 256 - 256 % cpr owns the 16-byte chunk c = tid %
// cpr of every (S/cpr)-th row of the slot's row range, two rows in flight.
// KM taps at most (K itself for the recipe's K = 3, so the accumulators
// stay few and four blocks fit an SM).
template <typename T, int EPC, int KM>
__global__ void __launch_bounds__(kWgThreads)
wgrad_stream_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    float* __restrict__ part_w, float* __restrict__ part_b,
                    int B, int T_len, int Cout, int K, int dil, int has_leaky,
                    float slope, int n_slots) {
  extern __shared__ float4 wg_smem4[];
  float* red = reinterpret_cast<float*>(wg_smem4);
  const int lo = (K - 1) / 2 * dil;
  const int slot = blockIdx.x;
  const int cpr = Cout / EPC;
  const int S = kWgThreads - kWgThreads % cpr;
  const int step = S / cpr;
  const long long n_rows = (long long)B * T_len;
  const long long r0 = part_begin(n_rows, slot, n_slots);
  const long long r1 = part_begin(n_rows, slot + 1, n_slots);

  float acc[KM][EPC];
  float bacc[EPC];
#pragma unroll
  for (int e = 0; e < EPC; ++e) {
    bacc[e] = 0.f;
#pragma unroll
    for (int k = 0; k < KM; ++k) acc[k][e] = 0.f;
  }
  const T* gc = g + (threadIdx.x % cpr) * EPC;  // this thread's chunk
  auto load_g = [&](long long r, float (&gv)[EPC]) {
    const T* gp = gc + r * Cout;
    if constexpr (EPC * sizeof(T) == 16) {
      const uint4 u4 = *reinterpret_cast<const uint4*>(gp);
      const T* e = reinterpret_cast<const T*>(&u4);
#pragma unroll
      for (int i = 0; i < EPC; ++i) gv[i] = to_f32(e[i]);
    } else {
#pragma unroll
      for (int i = 0; i < EPC; ++i) gv[i] = to_f32(gp[i]);
    }
  };
  auto add_row = [&](int b, int t, const float (&gv)[EPC]) {
    const T* xb = x + (size_t)b * T_len;
#pragma unroll
    for (int k = 0; k < KM; ++k) {
      if (k >= K) break;
      const int tt = t - lo + k * dil;
      float xv = 0.f;
      if (tt >= 0 && tt < T_len) {
        xv = to_f32(xb[tt]);
        if (has_leaky) xv = round_to(leaky(xv, slope), T());
      }
#pragma unroll
      for (int i = 0; i < EPC; ++i) acc[k][i] = fmaf(xv, gv[i], acc[k][i]);
    }
#pragma unroll
    for (int i = 0; i < EPC; ++i) bacc[i] += gv[i];
  };
  if ((int)threadIdx.x < S) {
    long long r = r0 + threadIdx.x / cpr;
    int b = (int)(r / T_len), t = (int)(r - (long long)b * T_len);
    for (; r < r1; r += 2 * step) {
      // rows r and r + step: both loads before either product
      int b2 = b, t2 = t + step;
      while (t2 >= T_len) { t2 -= T_len; ++b2; }
      const bool two = r + step < r1;
      float gv[EPC], gv2[EPC];
      load_g(r, gv);
      if (two) load_g(r + step, gv2);
      add_row(b, t, gv);
      if (two) add_row(b2, t2, gv2);
      b = b2; t = t2 + step;
      while (t >= T_len) { t -= T_len; ++b; }
    }
  }
  // each thread's K+1 rows of EPC sums, then one thread per (k, o) adds the
  // threads that hold o in thread order
  const int w_ld = (K + 1) * EPC;
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    if (k >= K) break;
#pragma unroll
    for (int i = 0; i < EPC; ++i) red[threadIdx.x * w_ld + k * EPC + i] = acc[k][i];
  }
#pragma unroll
  for (int i = 0; i < EPC; ++i) red[threadIdx.x * w_ld + K * EPC + i] = bacc[i];
  __syncthreads();
  for (int idx = threadIdx.x; idx < (K + 1) * Cout; idx += kWgThreads) {
    const int k = idx / Cout, o = idx - k * Cout;
    const int c = o / EPC, e = o - c * EPC;
    float v = 0.f;
    for (int rr = 0; rr < step; ++rr) v += red[(rr * cpr + c) * w_ld + k * EPC + e];
    if (k < K) part_w[((size_t)slot * K + k) * Cout + o] = v;
    else part_b[(size_t)slot * Cout + o] = v;
  }
}

struct WgradArgs {
  const void* x; const void* g; float* part_w; float* part_b;
  int B, T_len, Cin, Cout, K, dil, has_leaky;
  float slope;
  int rows, n_slots, ics, n_islabs, n_oslabs;
  cudaStream_t stream;
};

template <typename Kern>
int set_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int NTB, int PPW>
int launch_wgrad_mma(const WgradArgs& a) {
  constexpr int OCS = NTB * 8;
  if (a.Cin % 8 || a.Cin < 16 || a.Cout % 8 || a.rows % 16 || a.ics % 16 ||
      a.K * a.ics / 16 > 8 * PPW || a.n_islabs != (a.Cin + a.ics - 1) / a.ics ||
      a.n_oslabs != (a.Cout + OCS - 1) / OCS)
    return (int)cudaErrorInvalidValue;
  const int stages = (long long)a.B * ((a.T_len + a.rows - 1) / a.rows) > a.n_slots ? 2 : 1;
  const size_t smem = (size_t)stages *
      ((a.rows + (a.K - 1) * a.dil) * odd_ld(a.ics) + a.rows * odd_ld(OCS)) *
      sizeof(bf16);
  auto kern = wgrad_mma_kernel<NTB, PPW>;
  if (int e = set_smem(kern, smem)) return e;
  dim3 grid(a.n_slots, a.n_islabs * a.n_oslabs);
  kern<<<grid, kWgThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.x), static_cast<const bf16*>(a.g), a.part_w,
      a.part_b, a.B, a.T_len, a.Cin, a.Cout, a.K, a.dil, a.has_leaky, a.slope,
      a.rows, a.n_slots, a.ics, a.n_oslabs);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wgrad_ffma(const WgradArgs& a) {
  if (a.ics % 4 || a.ics > 32 || a.K * (a.ics / 4) * (kFfOcs / 8) > kWgThreads ||
      a.n_islabs != (a.Cin + a.ics - 1) / a.ics ||
      a.n_oslabs != (a.Cout + kFfOcs - 1) / kFfOcs)
    return (int)cudaErrorInvalidValue;
  const int stages = (long long)a.B * ((a.T_len + a.rows - 1) / a.rows) > a.n_slots ? 2 : 1;
  const size_t stage_bytes = (size_t)((a.rows + (a.K - 1) * a.dil) * (a.ics + 4) +
                                      a.rows * (kFfOcs + 4)) * sizeof(float);
  const size_t red_bytes = (size_t)kWgThreads * 33 * sizeof(float);
  const size_t smem = stages * stage_bytes > red_bytes ? stages * stage_bytes
                                                       : red_bytes;
  auto kern = wgrad_ffma_kernel<T>;
  if (int e = set_smem(kern, smem)) return e;
  dim3 grid(a.n_slots, a.n_islabs * a.n_oslabs);
  kern<<<grid, kWgThreads, smem, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.g), a.part_w,
      a.part_b, a.B, a.T_len, a.Cin, a.Cout, a.K, a.dil, a.has_leaky, a.slope,
      a.rows, a.n_slots, a.ics, a.n_oslabs);
  return (int)cudaGetLastError();
}

template <typename T, int EPC>
int launch_wgrad_stream(const WgradArgs& a) {
  if (a.Cin != 1 || a.K > kStreamKMax || a.Cout % EPC || a.Cout / EPC > kWgThreads)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kWgThreads * (a.K + 1) * EPC * sizeof(float);
  auto kern = a.K <= 3 ? wgrad_stream_kernel<T, EPC, 3>
                       : wgrad_stream_kernel<T, EPC, kStreamKMax>;
  if (int e = set_smem(kern, smem)) return e;
  kern<<<a.n_slots, kWgThreads, smem, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.g), a.part_w,
      a.part_b, a.B, a.T_len, a.Cout, a.K, a.dil, a.has_leaky, a.slope,
      a.n_slots);
  return (int)cudaGetLastError();
}

// tile_n: the mma variant's output slab (24 or 48), the stream variant's
// elements per g chunk (1 or 16 bytes' worth); ppw: the mma variant's
// (tap, 16-channel) pairs per warp
template <typename T>
int wgrad(const WgradArgs& a, int variant, int tile_n, int ppw, float* dw,
          float* db) {
  int err = (int)cudaErrorInvalidValue;
  if (variant == kWgMma) {
    if constexpr (sizeof(T) == 2) {
      if (tile_n == 24 && ppw == 1) err = launch_wgrad_mma<3, 1>(a);
      else if (tile_n == 24 && ppw == 2) err = launch_wgrad_mma<3, 2>(a);
      else if (tile_n == 24 && ppw == 3) err = launch_wgrad_mma<3, 3>(a);
      else if (tile_n == 48 && ppw == 1) err = launch_wgrad_mma<6, 1>(a);
      else if (tile_n == 48 && ppw == 2) err = launch_wgrad_mma<6, 2>(a);
      else if (tile_n == 48 && ppw == 3) err = launch_wgrad_mma<6, 3>(a);
    }
  } else if (variant == kWgFfma) {
    if (tile_n == kFfOcs) err = launch_wgrad_ffma<T>(a);
  } else if (variant == kWgStream) {
    if (tile_n == 1) err = launch_wgrad_stream<T, 1>(a);
    else if (tile_n == 16 / (int)sizeof(T)) err = launch_wgrad_stream<T, 16 / sizeof(T)>(a);
  }
  if (err != 0) return err;
  return launch_slot_reduce(a.part_w, a.part_b, dw, db,
                            (long long)a.K * a.Cin * a.Cout, a.Cout,
                            a.n_slots, a.stream);
}

}  // namespace

// dx (B, T, Cin) from g (B, T, Cout), both contiguous. w points at the
// weight's LAST tap and (swk, swi, swo) step it back in K, along the dx
// conv's input channels (the forward's Cout) and along its outputs (the
// forward's Cin). mask_x (B, T, Cin) or null: the forward's pre-activation.
// variant, tm and tn: the plan of the dx conv (ops/window_conv.py::fwd_plan
// with Cin and Cout swapped).
extern "C" int window_conv_dx_f32(const void* g, const void* w,
                                  const void* mask_x, void* dx, void* wpack, int B,
                                  int T_len, int Cout, int Cin, int K, int dil,
                                  long long swk, long long swi, long long swo,
                                  float slope, int variant, int tm, int tn,
                                  void* stream) {
  const ConvArgs a{g, w, nullptr, mask_x, dx, wpack, B, T_len, Cout, Cin, K, dil,
                   (K - 1) / 2 * dil, swk, swi, swo, 0, 0.f, slope,
                   static_cast<cudaStream_t>(stream)};
  return dispatch_window_conv<float, 1>(a, variant, tm, tn);
}

extern "C" int window_conv_dx_bf16(const void* g, const void* w,
                                   const void* mask_x, void* dx, void* wpack, int B,
                                   int T_len, int Cout, int Cin, int K,
                                   int dil, long long swk, long long swi,
                                   long long swo, float slope, int variant,
                                   int tm, int tn, void* stream) {
  const ConvArgs a{g, w, nullptr, mask_x, dx, wpack, B, T_len, Cout, Cin, K, dil,
                   (K - 1) / 2 * dil, swk, swi, swo, 0, 0.f, slope,
                   static_cast<cudaStream_t>(stream)};
  return dispatch_window_conv<bf16, 1>(a, variant, tm, tn);
}

// x (B, T, Cin) and g (B, T, Cout) contiguous; part_w (n_slots, K, Cin,
// Cout) and part_b (n_slots, Cout) f32 scratch; dw (K, Cin, Cout) and db
// (Cout,) f32 out. variant, rows, n_slots, ics, n_islabs, n_oslabs, tile_n
// and ppw are the caller's plan (ops/window_conv.py::wgrad_plan).
#define WGRAD_ENTRY(NAME, T)                                                   \
  extern "C" int NAME(const void* x, const void* g, void* part_w,              \
                      void* part_b, void* dw, void* db, int B, int T_len,      \
                      int Cin, int Cout, int K, int dil, int has_leaky,        \
                      float slope, int variant, int rows, int n_slots,         \
                      int ics, int n_islabs, int n_oslabs, int tile_n,         \
                      int ppw, void* stream) {                                 \
    const WgradArgs a{x, g, static_cast<float*>(part_w),                       \
                      static_cast<float*>(part_b), B, T_len, Cin, Cout, K,     \
                      dil, has_leaky, slope, rows, n_slots, ics, n_islabs,     \
                      n_oslabs, static_cast<cudaStream_t>(stream)};            \
    return wgrad<T>(a, variant, tile_n, ppw, static_cast<float*>(dw),          \
                    static_cast<float*>(db));                                  \
  }

WGRAD_ENTRY(window_conv_wgrad_f32, float)
WGRAD_ENTRY(window_conv_wgrad_bf16, bf16)
