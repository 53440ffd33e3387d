// The gated residual block of the HN-uSFGAN vocoder on one group of rows,
// shared by the per-block kernels (pd_block.cu) and the fused chain of
// fixed blocks (pd_chain.cu). Channels-last (B, T, R) stream x and
// (B, T, A) conditioning c:
//
//   h[t] = x[m(t)] @ Wm + x[t] @ Wc + x[p(t)] @ Wp + c[t] @ Wa + bg   (G wide)
//   z[t] = tanh(h[t, :G/2]) * sigmoid(h[t, G/2:])    rounded to x's type
//   y[t] = (z[t] @ Wo + bo + x[t]) * sqrt(0.5)        cast to x's type
//
// Arithmetic as the TPU kernels: products of the stored values summed in
// f32 (true f32 FFMA: no TF32, no bf16 truncation of f32 inputs), gate in
// f32, z rounded to the stream type before the out product, output cast to
// the stream type.
//
// What bounds it on the H100: the operations, 2 * (3R + A) * G + 2 * (G/2)
// * R per row, against the f32 CUDA-core rate (at 8 x 24000 rows and R 64,
// G 128, A 62: 0.21 ms at the H100 SXM's published 67 TFLOP/s, 700 W), in
// both types, since bf16 is also computed in f32 here; the bytes of x, c
// and y (0.022 ms in bf16 at 3.35 TB/s) would bound a tensor-core version.
// `gated_block_rows` is a register-tiled FFMA loop: a block of 256 threads
// takes 128 rows, stages the (32 x 128) input slab and the (32 x G) weight
// slab of each chunk of the 3R + A input features in shared memory,
// k-major, and each thread keeps 8 rows x (4 + 4) gate columns (a gate pair
// per column, so the gate is applied in registers) and reads its operands
// as float4s; z and Wo then go through shared memory for the out product
// (8 rows x 4 columns a thread). Where the rows come from and where they go
// is the caller's `Rows` policy: device memory (pd_block.cu) or shared
// memory (pd_chain.cu). The sums run in the same order either way, so a
// chain in f32 gives the per-block kernels' bits. wgmma and TMA are for a
// later change.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

// One block's weights. Every field is 8 bytes, in the order of
// ops/pd_block.py's _Weights, so the ctypes structure has the same layout.
// Strides count elements.
struct PdBlockWeights {
  const void* w[3];  // taps m, c, p: (R, G) through (w_si, w_so)
  long long w_si[3];
  long long w_so[3];
  const void* wa;  // (A, G)
  long long wa_si, wa_so;
  const void* bg[3];  // gate biases (G,), summed in order; null = absent
  const void* wo;     // (G/2, R)
  long long wo_si, wo_so;
  const void* bo;  // (R,)
};

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 128;     // rows (time steps) per group
constexpr int kKC = 32;        // input features per chunk
constexpr int kMaxHalf = 64;   // G / 2 at most
constexpr int kMaxR = 64;      // R at most
// shared-memory row lengths, padded by one float4
constexpr int kRowPad = kRows + 4;       // a_s[kk][row], z_s[k][row]
constexpr int kWPad = 2 * kMaxHalf + 4;  // w_s[kk][half * kMaxHalf + col]
constexpr int kOPad = kMaxR + 4;         // o_s[k][col]
constexpr int kPhase1 = kKC * kRowPad + kKC * kWPad;
constexpr int kPhase2 = kMaxHalf * kRowPad + kMaxHalf * kOPad;
constexpr int kSmemFloats = kPhase1 > kPhase2 ? kPhase1 : kPhase2;
// the staging area and the [3][kRows] tap rows
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float) + 3 * kRows * sizeof(int);
constexpr size_t kMaxSmemBytes = 232448;  // what one block may use on the H100
constexpr float kSqrtHalf = 0.70710678118654752f;

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
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// reflect t - dil and t + dil into [0, T): -k -> k, T-1+k -> T-1-k (T > dil)
__device__ __forceinline__ int reflect_lo(int t, int dil) {
  return t - dil < 0 ? dil - t : t - dil;
}
__device__ __forceinline__ int reflect_hi(int t, int dil, int T_len) {
  return t + dil >= T_len ? 2 * (T_len - 1) - t - dil : t + dil;
}

template <typename T>
__device__ __forceinline__ float gate_bias(const PdBlockWeights& p, int o) {
  float v = to_f32(static_cast<const T*>(p.bg[0])[o]);
  for (int i = 1; i < 3; ++i)
    if (p.bg[i] != nullptr)
      v = round_to<T>(v + to_f32(static_cast<const T*>(p.bg[i])[o]));
  return v;
}

// One block on the group's kRows rows. `src[tap * kRows + r]` is row r's
// source row for each tap (-1 reads zero), written by the caller before the
// call. The policy `rows` gives
//   tap(s, f)      the stream at source row s >= 0, feature f
//   valid(r)       whether row r of the group is computed
//   aux(r, a)      the conditioning of row r
//   resid(r, o)    the stream at row r (the residual)
//   store(r, o, v) row r's output before its cast to the stream type.
// Each thread owns rows r0..r0+7 and columns c0..c0+3 (r0 = 8 * (tid / 16),
// c0 = 4 * (tid % 16)): gate columns c0.. and G/2 + c0.. in the first
// product, output columns c0.. in the second. Shared-memory operands are
// stored k-major so that a thread's rows and columns are float4 loads. The
// call ends with the staging area free again, so a caller may loop over
// groups; stores go after the last barrier and must not touch `smem`.
template <typename T, typename Rows>
__device__ __forceinline__ void gated_block_rows(const PdBlockWeights& p,
                                                 const Rows& rows, int R, int A,
                                                 int G2, float* smem,
                                                 const int* src) {
  const int KIN = 3 * R + A;
  const int tid = threadIdx.x;
  const int r0 = 8 * (tid / 16), c0 = 4 * (tid % 16);

  // the gate product: acc_a for gate columns c0 + j, acc_b for G2 + c0 + j
  float acc_a[8][4], acc_b[8][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int o = c0 + j;
    const float ba = o < G2 ? gate_bias<T>(p, o) : 0.f;
    const float bb = o < G2 ? gate_bias<T>(p, G2 + o) : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc_a[i][j] = ba;
      acc_b[i][j] = bb;
    }
  }
  float* a_s = smem;                   // [kKC][kRowPad]
  float* w_s = smem + kKC * kRowPad;   // [kKC][kWPad]
  // weights are read along whichever of their two strides is unit-like
  const bool k_fast = p.w_si[0] <= p.w_so[0];
  __syncthreads();
  for (int k0 = 0; k0 < KIN; k0 += kKC) {
    for (int idx = tid; idx < kRows * kKC; idx += kThreads) {
      const int r = idx / kKC, kk = idx % kKC, f = k0 + kk;
      float v = 0.f;
      if (f < 3 * R) {
        const int tap = f / R, s = src[tap * kRows + r];
        if (s >= 0) v = rows.tap(s, f - tap * R);
      } else if (f < KIN && rows.valid(r)) {
        v = rows.aux(r, f - 3 * R);
      }
      a_s[kk * kRowPad + r] = v;
    }
    for (int idx = tid; idx < kKC * 2 * kMaxHalf; idx += kThreads) {
      int kk, hc;
      if (k_fast) {
        kk = idx % kKC;
        hc = idx / kKC;
      } else {
        kk = idx / (2 * kMaxHalf);
        hc = idx % (2 * kMaxHalf);
      }
      const int half = hc / kMaxHalf, col = hc % kMaxHalf, f = k0 + kk;
      float v = 0.f;
      if (col < G2) {
        const long long o = (long long)half * G2 + col;
        if (f < 3 * R) {
          const int tap = f / R;
          v = to_f32(static_cast<const T*>(p.w[tap])[
              (f - tap * R) * p.w_si[tap] + o * p.w_so[tap]]);
        } else if (f < KIN) {
          v = to_f32(static_cast<const T*>(p.wa)[
              (f - 3 * R) * p.wa_si + o * p.wa_so]);
        }
      }
      w_s[kk * kWPad + hc] = v;
    }
    __syncthreads();
    const int kn = min(kKC, KIN - k0);
#pragma unroll 2
    for (int kk = 0; kk < kn; ++kk) {
      const float4 a_lo = ld4(a_s + kk * kRowPad + r0);
      const float4 a_hi = ld4(a_s + kk * kRowPad + r0 + 4);
      const float4 wa4 = ld4(w_s + kk * kWPad + c0);
      const float4 wb4 = ld4(w_s + kk * kWPad + kMaxHalf + c0);
      const float a[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w,
                          a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float wa[4] = {wa4.x, wa4.y, wa4.z, wa4.w};
      const float wb[4] = {wb4.x, wb4.y, wb4.z, wb4.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc_a[i][j] = fmaf(a[i], wa[j], acc_a[i][j]);
          acc_b[i][j] = fmaf(a[i], wb[j], acc_b[i][j]);
        }
    }
    __syncthreads();
  }

  // the gate, in f32, z rounded to the stream type
  float* z_s = smem;                      // [kMaxHalf][kRowPad]
  float* o_s = smem + kMaxHalf * kRowPad;  // [kMaxHalf][kOPad]
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int o = c0 + j;
    if (o >= G2) continue;
    float z[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      z[i] = round_to<T>(tanhf(acc_a[i][j]) / (1.f + expf(-acc_b[i][j])));
    float4* zp = reinterpret_cast<float4*>(z_s + o * kRowPad + r0);
    zp[0] = make_float4(z[0], z[1], z[2], z[3]);
    zp[1] = make_float4(z[4], z[5], z[6], z[7]);
  }
  const bool ko_fast = p.wo_si <= p.wo_so;
  for (int idx = tid; idx < kMaxHalf * kMaxR; idx += kThreads) {
    int k, o;
    if (ko_fast) {
      k = idx % kMaxHalf;
      o = idx / kMaxHalf;
    } else {
      k = idx / kMaxR;
      o = idx % kMaxR;
    }
    float v = 0.f;
    if (k < G2 && o < R)
      v = to_f32(static_cast<const T*>(p.wo)[k * p.wo_si + o * p.wo_so]);
    o_s[k * kOPad + o] = v;
  }
  __syncthreads();

  // the out product, bias, residual and scale
  float out[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
#pragma unroll 2
  for (int k = 0; k < G2; ++k) {
    const float4 z_lo = ld4(z_s + k * kRowPad + r0);
    const float4 z_hi = ld4(z_s + k * kRowPad + r0 + 4);
    const float4 w4 = ld4(o_s + k * kOPad + c0);
    const float zv[8] = {z_lo.x, z_lo.y, z_lo.z, z_lo.w,
                         z_hi.x, z_hi.y, z_hi.z, z_hi.w};
    const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) out[i][j] = fmaf(zv[i], wv[j], out[i][j]);
  }
  __syncthreads();
  const T* bo = static_cast<const T*>(p.bo);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + i;
    if (!rows.valid(r)) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = c0 + j;
      if (o >= R) continue;
      const float v = out[i][j] + to_f32(bo[o]);
      rows.store(r, o, (v + rows.resid(r, o)) * kSqrtHalf);
    }
  }
}

}  // namespace
