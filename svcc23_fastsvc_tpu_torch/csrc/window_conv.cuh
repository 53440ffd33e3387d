// Stride-1 "same" dilated 1-D convolution with an optional fused input
// leaky-relu, channels-last, shared by the forward (window_conv.cu) and the
// input gradient (window_conv_grad.cu):
//
//   y[b, t, o] = bias[o] + sum_k sum_i act(x)[b, t - lo + k*dil, i] * w[k, i, o]
//
// with zeros outside [0, T), act = leaky_relu(., slope) applied in f32 (or
// the identity). f32 and bf16 in and out, f32 sums. The window conv passes
// lo = (K-1)/2 * dil; the fused conv (fused_conv.cu) any lo in [0, span],
// span = (K-1) * dil, the output as long as the input either way.
//
// The weight is read through element strides (swk, swi, swo), so a caller
// passes a transposed or K-reversed view (a negative swk from a pointer at
// the last tap) without a copy. An optional epilogue multiplies the output,
// rounded to T, by the leaky-relu derivative of a tensor shaped like y
// (where(m >= 0, 1, mask_slope) in f32) and rounds again: the chain rule
// of the input gradient through the forward's fused activation.
//
// Replaces the TPU kernel svcc23_fastsvc_tpu/ops/pallas_window_conv.py
// window_conv_fwd (_fwd_kernel). That kernel streams a [halo | tile | halo]
// window of x into VMEM once and takes the K taps as offsets into it; this
// one does the same per thread block in shared memory. The TPU kernel keeps
// all of W (K, Cin, Cout) in VMEM, which at the generator's 2C = 384 FiLM
// conv (1.7 MB in f32) does not fit a block's 227 KB, so here the block
// tiles Cout (TCO columns) and walks Cin in chunks of CI channels, loading
// each chunk's input window and weight slab once.
//
// What bounds it on the H100: at the generator's shapes the operations
// (2*K*Cin*Cout per output row) against the f32 CUDA-core rate, or the
// bytes of x and y at C = 24 and Cin = 1. This first version is a simple
// register-tiled FFMA loop (each thread 4 rows x 4 columns); wgmma and TMA
// are for a later change.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCI = 32;           // input channels per chunk
constexpr int kRowStride = kCI + 1;  // padded shared-memory row: no bank conflicts

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
// the activated input is rounded to the storage type, as the TPU kernel
// stores it back into its window scratch
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.f ? v : v * slope;
}

// TCO output columns per block; TX threads across columns (4 each, strided
// by TX), TY = kThreads / TX threads across rows (4 each, strided by TY).
// kPass (0 forward, 1 input gradient) only names the instance, so that a
// profile tells the two apart.
template <typename T, int TCO, int kPass>
__global__ void __launch_bounds__(kThreads)
window_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ bias, const T* __restrict__ mask,
                   T* __restrict__ y, int T_len, int Cin, int Cout, int K,
                   int dil, int lo, long long swk, long long swi,
                   long long swo, int has_leaky, float slope,
                   float mask_slope) {
  constexpr int TX = TCO / 4;
  constexpr int TY = kThreads / TX;
  constexpr int TT = 4 * TY;  // output rows per block
  extern __shared__ float smem[];
  const int win_rows = TT + (K - 1) * dil;
  float* win = smem;                                // win_rows x kRowStride
  float* wsm = smem + (size_t)win_rows * kRowStride;  // K x kCI x TCO

  const int b = blockIdx.z;
  const int t0 = blockIdx.x * TT;
  const int co0 = blockIdx.y * TCO;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const T* xb = x + (size_t)b * T_len * Cin;

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int co = co0 + tx + TX * j;
    const float bv = (bias != nullptr && co < Cout) ? to_f32(bias[co]) : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i][j] = bv;
  }

  for (int ci0 = 0; ci0 < Cin; ci0 += kCI) {
    const int cn = min(kCI, Cin - ci0);
    // input window rows [t0 - lo, t0 + TT + span - lo), zeros outside [0, T)
    for (int idx = threadIdx.x; idx < win_rows * kCI; idx += kThreads) {
      const int r = idx / kCI, c = idx % kCI;
      const int t = t0 - lo + r;
      float v = 0.f;
      if (c < cn && t >= 0 && t < T_len) {
        v = to_f32(xb[(size_t)t * Cin + ci0 + c]);
        if (has_leaky) v = round_to(leaky(v, slope), T());
      }
      win[r * kRowStride + c] = v;
    }
    for (int idx = threadIdx.x; idx < K * kCI * TCO; idx += kThreads) {
      const int o = idx % TCO, c = (idx / TCO) % kCI, k = idx / (TCO * kCI);
      float v = 0.f;
      if (c < cn && co0 + o < Cout)
        v = to_f32(w[k * swk + (ci0 + c) * swi + (co0 + o) * swo]);
      wsm[idx] = v;
    }
    __syncthreads();
    for (int k = 0; k < K; ++k) {
      const float* wk = wsm + k * kCI * TCO;
      const float* wrow = win + (size_t)(ty + k * dil) * kRowStride;
#pragma unroll 4
      for (int c = 0; c < cn; ++c) {
        float a[4], bw[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = wrow[(size_t)(TY * i) * kRowStride + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) bw[j] = wk[c * TCO + tx + TX * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  const size_t row0 = (size_t)b * T_len;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + TY * i;
    if (t >= T_len) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + tx + TX * j;
      if (co >= Cout) continue;
      const size_t at = (row0 + t) * Cout + co;
      float v = acc[i][j];
      if (mask != nullptr)
        v = round_to(v, T()) * (to_f32(mask[at]) >= 0.f ? 1.f : mask_slope);
      y[at] = from_f32<T>(v);
    }
  }
}

template <typename T, int TCO, int kPass>
int launch_window_conv(const void* x, const void* w, const void* b,
                       const void* mask, void* y, int B, int T_len, int Cin,
                       int Cout, int K, int dil, int lo, long long swk,
                       long long swi, long long swo, int has_leaky,
                       float slope, float mask_slope, cudaStream_t stream) {
  constexpr int TT = 4 * (kThreads / (TCO / 4));
  const size_t smem =
      ((size_t)(TT + (K - 1) * dil) * kRowStride + (size_t)K * kCI * TCO) *
      sizeof(float);
  auto kern = window_conv_kernel<T, TCO, kPass>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((T_len + TT - 1) / TT, (Cout + TCO - 1) / TCO, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<const T*>(mask),
      static_cast<T*>(y), T_len, Cin, Cout, K, dil, lo, swk, swi, swo,
      has_leaky, slope, mask_slope);
  return (int)cudaGetLastError();
}

template <typename T, int kPass>
int dispatch_window_conv(const void* x, const void* w, const void* b,
                         const void* mask, void* y, int B, int T_len, int Cin,
                         int Cout, int K, int dil, int lo, long long swk,
                         long long swi, long long swo, int has_leaky,
                         float slope, float mask_slope, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // narrow outputs (the generator's 24-channel convs) take 32-column tiles
  // so that fewer threads compute padding columns
  if (Cout <= 32)
    return launch_window_conv<T, 32, kPass>(x, w, b, mask, y, B, T_len, Cin,
                                            Cout, K, dil, lo, swk, swi, swo,
                                            has_leaky, slope, mask_slope, s);
  return launch_window_conv<T, 64, kPass>(x, w, b, mask, y, B, T_len, Cin,
                                          Cout, K, dil, lo, swk, swi, swo,
                                          has_leaky, slope, mask_slope, s);
}

}  // namespace
