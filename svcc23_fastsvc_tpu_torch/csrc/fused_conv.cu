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
// uses the f32 slope. f32 and bf16 streams, f32 sums.
//
// fused_conv_fwd_* replaces svcc23_fastsvc_tpu/ops/pallas_conv.py _fwd_call
// (_fwd_kernel). It is the window-conv kernel of window_conv.cuh with its
// window started at t0 - lo: the TPU kernel assembles the same
// (left halo | tile | right halo) window in VMEM and takes each tap as an
// offset into it. What bounds it on the H100 and its two variants (bf16
// mma.sync on the tensor cores, f32 FFMA) are said in window_conv.cuh.
//
// fused_conv_bwd_* replaces _bwd_call (_bwd_kernel), which reads x and g
// once and accumulates dw and db in f32 VMEM blocks revisited across the
// TPU's sequential grid. Here blocks run in parallel in no order, so the
// sum over the B*T rows is split two ways, deterministically, as in
// window_conv_grad.cu: block s takes a fixed range of row tiles (kRows rows
// of one utterance each, the range depending on the shapes alone), and for
// each tile it
//   1. loads the activated x window, rows [t0 - lo, t0 + kRows + hi), and
//      the g window, rows [t0 - hi, t0 + kRows + lo), all channels, into
//      shared memory, once;
//   2. computes dx for the tile's rows from the g window (the transposed
//      conv: pads (hi, lo), the weight reversed in K and transposed), times
//      the mask from the pre-activation x, rounded once to the stream type;
//   3. adds the tile's f32 sums of dw (x window against the tile's g rows)
//      and db into slot s of a scratch array, which only block s touches.
// A second pass sums the slots in slot order. No atomics, so dw and db are
// the same from run to run.
//
// What bounds it on the H100: the operations (2 * 2*K*Cin*Cout per row,
// dx and dw) against the f32 CUDA-core rate at 48 channels and more; at
// 24 channels and Cin = 1 the bytes of x, g and dx. Both products are
// register-tiled FFMA loops (each thread 4 x 4 outputs) over the shared
// windows; the weight is read through the L1 cache. wgmma and TMA are for a
// later change.

#include "window_conv.cuh"

namespace {

constexpr int kBwdThreads = 256;
constexpr int kRows = 64;        // rows of one row tile
constexpr int kRowGroups = kRows / 4;  // dx: threads across rows, 4 rows each

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
fused_conv_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                      const T* __restrict__ w, T* __restrict__ dx,
                      float* __restrict__ part_w, float* __restrict__ part_b,
                      int B, int T_len, int Cin, int Cout, int K, int dil,
                      int lo, long long swk, long long swi, long long swo,
                      int has_leaky, float act_slope, float mask_slope,
                      int n_slots) {
  extern __shared__ float smem[];
  const int span = (K - 1) * dil;
  const int hi = span - lo;
  const int win = kRows + span;
  const int xs_stride = Cin + 1;  // odd row strides: no bank conflicts
  const int gs_stride = Cout + 1;
  float* xs = smem;                                // act(x) window
  float* gs = smem + (size_t)win * xs_stride;      // g window

  const int qi = (Cin + 3) / 4;   // channel quads, strided by qi
  const int qo = (Cout + 3) / 4;
  const int n_ttiles = (T_len + kRows - 1) / kRows;
  const long long n_tiles = (long long)B * n_ttiles;
  const int slot = blockIdx.x;
  const long long j0 = n_tiles * slot / n_slots;
  const long long j1 = n_tiles * (slot + 1) / n_slots;
  const size_t n_w = (size_t)K * Cin * Cout;
  float* pw = part_w + (size_t)slot * n_w;
  float* pb = part_b + (size_t)slot * Cout;

  for (long long j = j0; j < j1; ++j) {
    const bool first = j == j0;
    const int b = (int)(j / n_ttiles);
    const int t0 = (int)(j % n_ttiles) * kRows;
    const T* xb = x + (size_t)b * T_len * Cin;
    const T* gb = g + (size_t)b * T_len * Cout;
    for (int idx = threadIdx.x; idx < win * Cin; idx += kBwdThreads) {
      const int r = idx / Cin, c = idx % Cin;
      const int t = t0 - lo + r;
      float v = 0.f;
      if (t >= 0 && t < T_len) {
        v = to_f32(xb[(size_t)t * Cin + c]);
        if (has_leaky) v = round_to(leaky(v, act_slope), T());
      }
      xs[r * xs_stride + c] = v;
    }
    for (int idx = threadIdx.x; idx < win * Cout; idx += kBwdThreads) {
      const int r = idx / Cout, c = idx % Cout;
      const int t = t0 - hi + r;
      gs[r * gs_stride + c] =
          (t >= 0 && t < T_len) ? to_f32(gb[(size_t)t * Cout + c]) : 0.f;
    }
    __syncthreads();

    // dx: rows ty + kRowGroups*m, channels q + qi*n; g window row of tap k
    // for output row r is r + span - k*dil
    if (dx != nullptr) {
      for (int tile = threadIdx.x; tile < kRowGroups * qi;
           tile += kBwdThreads) {
        const int ty = tile % kRowGroups, q = tile / kRowGroups;
        float acc[4][4];
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n) acc[m][n] = 0.f;
        for (int k = 0; k < K; ++k) {
          const float* grow = gs + (size_t)(ty + span - k * dil) * gs_stride;
          const T* wk = w + k * swk;
          for (int o = 0; o < Cout; ++o) {
            float a[4], wv[4];
#pragma unroll
            for (int m = 0; m < 4; ++m)
              a[m] = grow[(size_t)(kRowGroups * m) * gs_stride + o];
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              const int i = q + qi * n;
              wv[n] = i < Cin ? to_f32(wk[i * swi + o * swo]) : 0.f;
            }
#pragma unroll
            for (int m = 0; m < 4; ++m)
#pragma unroll
              for (int n = 0; n < 4; ++n) acc[m][n] = fmaf(a[m], wv[n], acc[m][n]);
          }
        }
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int t = t0 + ty + kRowGroups * m;
          if (t >= T_len) continue;
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int i = q + qi * n;
            if (i >= Cin) continue;
            const size_t at = ((size_t)b * T_len + t) * Cin + i;
            float v = acc[m][n];
            if (has_leaky) v *= to_f32(x[at]) >= 0.f ? 1.f : mask_slope;
            dx[at] = from_f32<T>(v);
          }
        }
      }
    }

    // dw partials: tap k, channels qx + qi*m, outputs qy + qo*n; the tile's
    // own g rows sit at r + hi of the g window, x row of tap k at r + k*dil
    for (int tile = threadIdx.x; tile < K * qi * qo; tile += kBwdThreads) {
      const int qy = tile % qo, qx = (tile / qo) % qi, k = tile / (qo * qi);
      float acc[4][4];
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[m][n] = 0.f;
      const int xo = k * dil;
      for (int r = 0; r < kRows; ++r) {
        const float* xrow = xs + (size_t)(r + xo) * xs_stride;
        const float* grow = gs + (size_t)(r + hi) * gs_stride;
        float a[4], gg[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int i = qx + qi * m;
          a[m] = i < Cin ? xrow[i] : 0.f;
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int o = qy + qo * n;
          gg[n] = o < Cout ? grow[o] : 0.f;
        }
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n) acc[m][n] = fmaf(a[m], gg[n], acc[m][n]);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int i = qx + qi * m;
        if (i >= Cin) continue;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int o = qy + qo * n;
          if (o >= Cout) continue;
          float* p = pw + ((size_t)k * Cin + i) * Cout + o;
          *p = first ? acc[m][n] : *p + acc[m][n];
        }
      }
    }
    for (int o = threadIdx.x; o < Cout; o += kBwdThreads) {
      float s = 0.f;
      for (int r = 0; r < kRows; ++r) s += gs[(size_t)(r + hi) * gs_stride + o];
      pb[o] = first ? s : pb[o] + s;
    }
    __syncthreads();
  }
}

// pass 2: one thread per element of dw (then of db), slots summed in order
__global__ void fused_conv_reduce_kernel(const float* __restrict__ part_w,
                                         const float* __restrict__ part_b,
                                         float* __restrict__ dw,
                                         float* __restrict__ db,
                                         long long n_w, int Cout,
                                         int n_slots) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_w) {
    float s = 0.f;
    for (int sp = 0; sp < n_slots; ++sp) s += part_w[sp * n_w + i];
    dw[i] = s;
  } else if (i < n_w + Cout) {
    const int o = (int)(i - n_w);
    float s = 0.f;
    for (int sp = 0; sp < n_slots; ++sp) s += part_b[(long long)sp * Cout + o];
    db[o] = s;
  }
}

template <typename T>
int fused_bwd(const void* x, const void* g, const void* w, void* dx,
              void* part_w, void* part_b, void* dw, void* db, int B,
              int T_len, int Cin, int Cout, int K, int dil, int lo,
              long long swk, long long swi, long long swo, int has_leaky,
              float act_slope, float mask_slope, int n_slots, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)(kRows + (K - 1) * dil) *
                      (size_t)(Cin + 1 + Cout + 1) * sizeof(float);
  auto kern = fused_conv_bwd_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<n_slots, kBwdThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const T*>(w), static_cast<T*>(dx),
      static_cast<float*>(part_w), static_cast<float*>(part_b), B, T_len, Cin,
      Cout, K, dil, lo, swk, swi, swo, has_leaky, act_slope, mask_slope,
      n_slots);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n = (long long)K * Cin * Cout + Cout;
  const int threads = 256;
  fused_conv_reduce_kernel<<<(unsigned)((n + threads - 1) / threads), threads,
                             0, s>>>(
      static_cast<const float*>(part_w), static_cast<const float*>(part_b),
      static_cast<float*>(dw), static_cast<float*>(db), n - Cout, Cout,
      n_slots);
  return (int)cudaGetLastError();
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
// (rounded) slope, mask_slope the f32 one.
extern "C" int fused_conv_bwd_f32(const void* x, const void* g, const void* w,
                                  void* dx, void* part_w, void* part_b,
                                  void* dw, void* db, int B, int T_len,
                                  int Cin, int Cout, int K, int dil, int lo,
                                  long long swk, long long swi, long long swo,
                                  int has_leaky, float act_slope,
                                  float mask_slope, int n_slots,
                                  void* stream) {
  return fused_bwd<float>(x, g, w, dx, part_w, part_b, dw, db, B, T_len, Cin,
                          Cout, K, dil, lo, swk, swi, swo, has_leaky,
                          act_slope, mask_slope, n_slots, stream);
}

extern "C" int fused_conv_bwd_bf16(const void* x, const void* g,
                                   const void* w, void* dx, void* part_w,
                                   void* part_b, void* dw, void* db, int B,
                                   int T_len, int Cin, int Cout, int K,
                                   int dil, int lo, long long swk,
                                   long long swi, long long swo,
                                   int has_leaky, float act_slope,
                                   float mask_slope, int n_slots,
                                   void* stream) {
  return fused_bwd<__nv_bfloat16>(x, g, w, dx, part_w, part_b, dw, db, B,
                                  T_len, Cin, Cout, K, dil, lo, swk, swi, swo,
                                  has_leaky, act_slope, mask_slope, n_slots,
                                  stream);
}
