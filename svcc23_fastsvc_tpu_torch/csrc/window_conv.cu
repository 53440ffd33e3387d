// Window-conv forward: the exported entry points of the kernels in
// window_conv.cuh (what they compute, what they replace, what bounds them
// and the two variants are said there).

#include "window_conv.cuh"

// x (B, T, Cin) and y (B, T, Cout) contiguous; w (K, Cin, Cout) addressed by
// the element strides swk, swi, swo; bias (Cout,) or null; wpack: the mma
// variant's scratch for the packed weight (K * Cout * ceil(Cin/32)*32 bf16),
// null for ffma. variant, tm and tn are the caller's plan
// (ops/window_conv.py::fwd_plan).
extern "C" int window_conv_fwd_f32(const void* x, const void* w, const void* b,
                                   void* y, void* wpack, int B, int T_len, int Cin,
                                   int Cout, int K, int dil, long long swk,
                                   long long swi, long long swo, int has_leaky,
                                   float slope, int variant, int tm, int tn,
                                   void* stream) {
  const ConvArgs a{x, w, b, nullptr, y, wpack, B, T_len, Cin, Cout, K, dil,
                   (K - 1) / 2 * dil, swk, swi, swo, has_leaky, slope, 0.f,
                   static_cast<cudaStream_t>(stream)};
  return dispatch_window_conv<float, 0>(a, variant, tm, tn);
}

extern "C" int window_conv_fwd_bf16(const void* x, const void* w, const void* b,
                                    void* y, void* wpack, int B, int T_len, int Cin,
                                    int Cout, int K, int dil, long long swk,
                                    long long swi, long long swo,
                                    int has_leaky, float slope, int variant,
                                    int tm, int tn, void* stream) {
  const ConvArgs a{x, w, b, nullptr, y, wpack, B, T_len, Cin, Cout, K, dil,
                   (K - 1) / 2 * dil, swk, swi, swo, has_leaky, slope, 0.f,
                   static_cast<cudaStream_t>(stream)};
  return dispatch_window_conv<bf16, 0>(a, variant, tm, tn);
}
