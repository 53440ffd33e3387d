// Gated residual blocks of the HN-uSFGAN vocoder, one kernel per block
// (the block's math, its arithmetic and what bounds it: pd_block.cuh). The
// two side taps m(t), p(t) of
//
//   h[t] = x[m(t)] @ Wm + x[t] @ Wc + x[p(t)] @ Wp + c[t] @ Wa + bg
//
// are, per kernel:
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
// masked), and reads those rows of x straight from device memory (L2
// holds x), so there is no halo, no alignment rule and no edge block.

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
};

namespace {

// rows of one block in device memory: group row r is stream row t0 + r
template <typename T>
struct GlobalRows {
  const T* x;
  const T* c;
  T* y;
  int t0, T_len, R, A;
  __device__ float tap(int s, int f) const { return to_f32(x[(size_t)s * R + f]); }
  __device__ bool valid(int r) const { return t0 + r < T_len; }
  __device__ float aux(int r, int a) const {
    return to_f32(c[(size_t)(t0 + r) * A + a]);
  }
  __device__ float resid(int r, int o) const {
    return to_f32(x[(size_t)(t0 + r) * R + o]);
  }
  __device__ void store(int r, int o, float v) const {
    y[(size_t)(t0 + r) * R + o] = from_f32<T>(v);
  }
};

template <typename T, bool kAdaptive>
__global__ void __launch_bounds__(kThreads, 2)
pd_block_kernel(const __grid_constant__ PdBlockArgs p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  int* src = reinterpret_cast<int*>(smem + kSmemFloats);  // [3][kRows], -1 reads 0

  const int T_len = (int)p.T, R = (int)p.R, A = (int)p.A;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kRows;
  const T* x = static_cast<const T*>(p.x) + (size_t)b * T_len * R;
  const T* c = static_cast<const T*>(p.c) + (size_t)b * T_len * A;
  T* y = static_cast<T*>(p.y) + (size_t)b * T_len * R;

  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    const int t = t0 + r;
    int m = -1, q = -1, n = -1;
    if (t < T_len) {
      q = t;
      if (kAdaptive) {
        // any int32 shift: in 64 bits neither tap overflows, and a tap
        // outside [0, T) reads zero, as in the plain gather
        const long long s = static_cast<const int*>(p.shifts)[
            (size_t)b * p.n_frames + t / (int)p.hop];
        const long long lo = t - s, hi = t + s;
        m = lo >= 0 && lo < T_len ? (int)lo : -1;
        n = hi >= 0 && hi < T_len ? (int)hi : -1;
      } else {
        m = reflect_lo(t, (int)p.dil);
        n = reflect_hi(t, (int)p.dil, T_len);
      }
    }
    src[r] = m;
    src[kRows + r] = q;
    src[2 * kRows + r] = n;
  }
  const GlobalRows<T> rows{x, c, y, t0, T_len, R, A};
  gated_block_rows<T>(p.wt, rows, R, A, (int)p.G / 2, smem, src);
}

template <typename T, bool kAdaptive>
int launch(const PdBlockArgs* a, void* stream) {
  if (a->R < 1 || a->R > kMaxR || a->G < 2 || a->G % 2 || a->G / 2 > kMaxHalf ||
      a->A < 0 || a->T < 1 || a->B < 1 || a->wt.bg[0] == nullptr)
    return (int)cudaErrorInvalidValue;
  if (kAdaptive ? (a->hop < 1 || a->T % a->hop || a->n_frames != a->T / a->hop)
                : (a->dil < 1 || a->T <= a->dil))
    return (int)cudaErrorInvalidValue;
  auto kern = pd_block_kernel<T, kAdaptive>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((a->T + kRows - 1) / kRows), (unsigned)a->B);
  kern<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
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
