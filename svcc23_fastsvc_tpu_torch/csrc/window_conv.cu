// Window-conv forward: the exported entry points of the kernel in
// window_conv.cuh (what it computes, what it replaces and what bounds it
// are said there).

#include "window_conv.cuh"

// x (B, T, Cin) and y (B, T, Cout) contiguous; w (K, Cin, Cout) addressed by
// the element strides swk, swi, swo; bias (Cout,) or null.
extern "C" int window_conv_fwd_f32(const void* x, const void* w, const void* b,
                                   void* y, int B, int T_len, int Cin,
                                   int Cout, int K, int dil, long long swk,
                                   long long swi, long long swo, int has_leaky,
                                   float slope, void* stream) {
  return dispatch_window_conv<float, 0>(x, w, b, nullptr, y, B, T_len, Cin,
                                        Cout, K, dil, (K - 1) / 2 * dil, swk,
                                        swi, swo, has_leaky, slope, 0.f,
                                        stream);
}

extern "C" int window_conv_fwd_bf16(const void* x, const void* w, const void* b,
                                    void* y, int B, int T_len, int Cin,
                                    int Cout, int K, int dil, long long swk,
                                    long long swi, long long swo,
                                    int has_leaky, float slope, void* stream) {
  return dispatch_window_conv<__nv_bfloat16, 0>(x, w, b, nullptr, y, B, T_len,
                                             Cin, Cout, K, dil,
                                             (K - 1) / 2 * dil, swk, swi, swo,
                                             has_leaky, slope, 0.f, stream);
}
