// Backward of the window conv (window_conv.cuh), channels-last:
//
//   dx_c[b, t, i] = sum_k sum_o g[b, t - lo + k*dil, o] * w[K-1-k, i, o]
//   dx = dx_c * where(x >= 0, 1, slope)       (when the forward had act)
//   dw[k, i, o]   = sum_{b,t} act(x)[b, t - lo + k*dil, i] * g[b, t, o]
//   db[o]         = sum_{b,t} g[b, t, o]
//
// dx replaces svcc23_fastsvc_tpu/ops/pallas_window_conv.py window_conv_dx,
// which reuses the forward kernel on g with the weight reversed in K and
// transposed. So does this one: window_conv_dx_* is the forward kernel with
// the weight read through a negative K stride and swapped channel strides,
// and the leaky-relu derivative of x applied in its epilogue (in f32, after
// rounding to the storage type, as the JAX package does it outside).
//
// wgrad replaces window_conv_wgrad (_wgrad_kernel), which sums dw and db in
// f32 VMEM scratch across the TPU's sequential grid. Here blocks run in no
// order, so the sum over the B*T rows (512,000 at the recipe's batch) is
// split two ways, deterministically: pass 1 gives each block one tile of
// dw (one tap k, TI input channels, TCO output channels) and a fixed range
// of row tiles (R rows of one utterance each), whose f32 partial sums it
// writes to a scratch slot of its own; pass 2 sums the slots in slot order.
// No atomics, so dw and db are the same from run to run. db comes from the
// g tiles the k = 0, first-channel-tile blocks already hold. The activated
// input is rounded to the storage type before the product, as the TPU
// kernel stores it back into its window, and rows past T contribute zero.
//
// What bounds it on the H100: the operations (2*K*Cin*Cout per row) against
// the f32 CUDA-core rate at 48 channels and more; the bytes of x and g at
// 24 channels and Cin = 1. Pass 1 is a register-tiled FFMA loop (each
// thread 4 input x 4 output channels), like the forward; wgmma and TMA are
// for a later change.

#include "window_conv.cuh"

namespace {

constexpr int kRows = 32;  // rows of one row tile

template <typename T, int TI, int TCO>
__global__ void __launch_bounds__((TI / 4) * (TCO / 4))
wgrad_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                     float* __restrict__ part_w, float* __restrict__ part_b,
                     int B, int T_len, int Cin, int Cout, int K, int dil,
                     int has_leaky, float slope, int n_splits) {
  constexpr int TX = TCO / 4;  // threads across output channels
  constexpr int TY = TI / 4;   // threads across input channels
  constexpr int NT = TX * TY;
  __shared__ float a_s[kRows][TI];
  __shared__ float g_s[kRows][TCO];

  const int n_ci = (Cin + TI - 1) / TI;
  const int co0 = blockIdx.x * TCO;
  const int k = blockIdx.y / n_ci;
  const int ci0 = (blockIdx.y % n_ci) * TI;
  const int split = blockIdx.z;
  const int shift = k * dil - (K - 1) / 2 * dil;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const bool with_db = blockIdx.y == 0;

  float acc[4][4];
  float bacc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bacc[j] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i][j] = 0.f;
  }

  // the fixed partition: split s takes row tiles [j0, j1)
  const int n_ttiles = (T_len + kRows - 1) / kRows;
  const long long n_tiles = (long long)B * n_ttiles;
  const long long j0 = n_tiles * split / n_splits;
  const long long j1 = n_tiles * (split + 1) / n_splits;
  for (long long j = j0; j < j1; ++j) {
    const int b = (int)(j / n_ttiles);
    const int t0 = (int)(j % n_ttiles) * kRows;
    const T* xb = x + (size_t)b * T_len * Cin;
    const T* gb = g + (size_t)b * T_len * Cout;
    for (int idx = threadIdx.x; idx < kRows * TI; idx += NT) {
      const int r = idx / TI, c = idx % TI;
      const int t = t0 + r + shift;
      float v = 0.f;
      if (ci0 + c < Cin && t >= 0 && t < T_len) {
        v = to_f32(xb[(size_t)t * Cin + ci0 + c]);
        if (has_leaky) v = round_to(leaky(v, slope), T());
      }
      a_s[r][c] = v;
    }
    for (int idx = threadIdx.x; idx < kRows * TCO; idx += NT) {
      const int r = idx / TCO, c = idx % TCO;
      const int t = t0 + r;
      g_s[r][c] = (co0 + c < Cout && t < T_len)
                      ? to_f32(gb[(size_t)t * Cout + co0 + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < kRows; ++r) {
      float a[4], gg[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_s[r][ty + TY * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) gg[j] = g_s[r][tx + TX * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], gg[j], acc[i][j]);
      if (with_db && ty == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) bacc[j] += gg[j];
      }
    }
    __syncthreads();
  }

  const size_t n_w = (size_t)K * Cin * Cout;
  float* pw = part_w + (size_t)split * n_w;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ci = ci0 + ty + TY * i;
    if (ci >= Cin) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + tx + TX * j;
      if (co < Cout) pw[((size_t)k * Cin + ci) * Cout + co] = acc[i][j];
    }
  }
  if (with_db && ty == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + tx + TX * j;
      if (co < Cout) part_b[(size_t)split * Cout + co] = bacc[j];
    }
  }
}

// pass 2: one thread per element of dw (then of db), slots summed in order
__global__ void wgrad_reduce_kernel(const float* __restrict__ part_w,
                                    const float* __restrict__ part_b,
                                    float* __restrict__ dw,
                                    float* __restrict__ db, long long n_w,
                                    int Cout, int n_splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_w) {
    float s = 0.f;
    for (int sp = 0; sp < n_splits; ++sp) s += part_w[sp * n_w + i];
    dw[i] = s;
  } else if (i < n_w + Cout) {
    const int o = (int)(i - n_w);
    float s = 0.f;
    for (int sp = 0; sp < n_splits; ++sp) s += part_b[(long long)sp * Cout + o];
    db[o] = s;
  }
}

template <typename T, int TI, int TCO>
int launch_wgrad(const void* x, const void* g, float* part_w, float* part_b,
                 int B, int T_len, int Cin, int Cout, int K, int dil,
                 int has_leaky, float slope, int n_splits,
                 cudaStream_t stream) {
  dim3 grid((Cout + TCO - 1) / TCO, K * ((Cin + TI - 1) / TI), n_splits);
  wgrad_partial_kernel<T, TI, TCO><<<grid, (TI / 4) * (TCO / 4), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), part_w, part_b, B,
      T_len, Cin, Cout, K, dil, has_leaky, slope, n_splits);
  return (int)cudaGetLastError();
}

template <typename T>
int wgrad(const void* x, const void* g, void* part_w, void* part_b, void* dw,
          void* db, int B, int T_len, int Cin, int Cout, int K, int dil,
          int has_leaky, float slope, int n_splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pw = static_cast<float*>(part_w);
  float* pb = static_cast<float*>(part_b);
  // 32-wide tiles where the channels are that narrow (the generator's 24-
  // channel convs and Cin = 1), 64-wide otherwise
  int err;
  if (Cin <= 32 && Cout <= 32)
    err = launch_wgrad<T, 32, 32>(x, g, pw, pb, B, T_len, Cin, Cout, K, dil,
                                  has_leaky, slope, n_splits, s);
  else if (Cin <= 32)
    err = launch_wgrad<T, 32, 64>(x, g, pw, pb, B, T_len, Cin, Cout, K, dil,
                                  has_leaky, slope, n_splits, s);
  else if (Cout <= 32)
    err = launch_wgrad<T, 64, 32>(x, g, pw, pb, B, T_len, Cin, Cout, K, dil,
                                  has_leaky, slope, n_splits, s);
  else
    err = launch_wgrad<T, 64, 64>(x, g, pw, pb, B, T_len, Cin, Cout, K, dil,
                                  has_leaky, slope, n_splits, s);
  if (err != 0) return err;
  const long long n = (long long)K * Cin * Cout + Cout;
  const int threads = 256;
  wgrad_reduce_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                        s>>>(pw, pb, static_cast<float*>(dw),
                             static_cast<float*>(db), n - Cout, Cout,
                             n_splits);
  return (int)cudaGetLastError();
}

}  // namespace

// dx (B, T, Cin) from g (B, T, Cout), both contiguous. w points at the
// weight's LAST tap and (swk, swi, swo) step it back in K, along the dx
// conv's input channels (the forward's Cout) and along its outputs (the
// forward's Cin). mask_x (B, T, Cin) or null: the forward's pre-activation.
extern "C" int window_conv_dx_f32(const void* g, const void* w,
                                  const void* mask_x, void* dx, int B,
                                  int T_len, int Cout, int Cin, int K, int dil,
                                  long long swk, long long swi, long long swo,
                                  float slope, void* stream) {
  return dispatch_window_conv<float, 1>(g, w, nullptr, mask_x, dx, B, T_len,
                                     Cout, Cin, K, dil, (K - 1) / 2 * dil,
                                     swk, swi, swo, 0, 0.f, slope, stream);
}

extern "C" int window_conv_dx_bf16(const void* g, const void* w,
                                   const void* mask_x, void* dx, int B,
                                   int T_len, int Cout, int Cin, int K,
                                   int dil, long long swk, long long swi,
                                   long long swo, float slope, void* stream) {
  return dispatch_window_conv<__nv_bfloat16, 1>(g, w, nullptr, mask_x, dx, B,
                                             T_len, Cout, Cin, K, dil,
                                             (K - 1) / 2 * dil, swk, swi, swo,
                                             0, 0.f, slope, stream);
}

// x (B, T, Cin) and g (B, T, Cout) contiguous; part_w (n_splits, K, Cin,
// Cout) and part_b (n_splits, Cout) f32 scratch; dw (K, Cin, Cout) and db
// (Cout,) f32 out.
extern "C" int window_conv_wgrad_f32(const void* x, const void* g,
                                     void* part_w, void* part_b, void* dw,
                                     void* db, int B, int T_len, int Cin,
                                     int Cout, int K, int dil, int has_leaky,
                                     float slope, int n_splits, void* stream) {
  return wgrad<float>(x, g, part_w, part_b, dw, db, B, T_len, Cin, Cout, K,
                      dil, has_leaky, slope, n_splits, stream);
}

extern "C" int window_conv_wgrad_bf16(const void* x, const void* g,
                                      void* part_w, void* part_b, void* dw,
                                      void* db, int B, int T_len, int Cin,
                                      int Cout, int K, int dil, int has_leaky,
                                      float slope, int n_splits,
                                      void* stream) {
  return wgrad<__nv_bfloat16>(x, g, part_w, part_b, dw, db, B, T_len, Cin,
                              Cout, K, dil, has_leaky, slope, n_splits,
                              stream);
}
