// The gated residual block of the HN-uSFGAN vocoder: its weights' layout
// (PdBlockWeights), the tap index helpers, the gate, and the two routines
// on a group of rows that the per-block kernels (pd_block.cu) and the fused
// chain of fixed blocks (pd_chain.cu) share. Channels-last (B, T, R) stream
// x and (B, T, A) conditioning c:
//
//   h[t] = x[m(t)] @ Wm + x[t] @ Wc + x[p(t)] @ Wp + c[t] @ Wa + bg   (G wide)
//   z[t] = tanh(h[t, :G/2]) * sigmoid(h[t, G/2:])    rounded to x's type
//   y[t] = (z[t] @ Wo + bo + x[t]) * sqrt(0.5)        cast to x's type
//
// Arithmetic as the TPU kernels: products of the stored values summed in
// f32 (true f32 FFMA: no TF32, no bf16 truncation of f32 inputs), gate in
// f32 (`gate`, tanhf and expf, the same in every variant), z rounded to the
// stream type before the out product, output cast to the stream type.
//
// `gated_block_rows` is a register-tiled FFMA loop: a block of 256 threads
// takes 128 rows, stages the (32 x 128) input slab and the (32 x G) weight
// slab of each chunk of the 3R + A input features in shared memory,
// k-major, and each thread keeps 8 rows x (4 + 4) gate columns (a gate pair
// per column, so the gate is applied in registers) and reads its operands
// as float4s; z and Wo then go through shared memory for the out product
// (8 rows x 4 columns a thread). Where the rows come from and where they go
// is the caller's `Rows` policy (shared memory in pd_chain.cu). It sums the
// features in order, bias first, as pd_block.cu's ffma kernels do, so a
// chain on it gives the per-block ffma kernels' bits. What bounds it on the
// H100: the operations in f32 FFMA, 2 * (3R + A) * G + 2 * (G/2) * R a row.
//
// `mma_block_rows` is the block on one warp's 16 rows on the tensor cores
// (bf16 operands, f32 sums), with the weights in shared memory as
// `stage_weights` lays them out. pd_block.cu's mma kernels and pd_chain.cu's
// mma stages both run it, so in bf16 too a chain gives the per-block
// kernels' bits.

#pragma once

#include "device_prims.cuh"

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
constexpr int kGateRows = 2 * kMaxHalf;  // gate columns in shared memory
constexpr int kMmaRows = 128;  // rows of an mma group: 8 warps x 16
constexpr int kOutLd = kMaxHalf + 8;  // Wo rows [o][k] for mma, 9 16-byte units

// the variant ids the wrappers pass (ops/pd_block.py::BLOCK_VARIANTS)
enum { kPdMma = 0, kPdFfma = 1 };

// mma rows of features: 3R + A padded with zeros to a multiple of 16 (kp),
// shared rows eight longer (an odd number of 16-byte units when kp / 8 is
// even, so ldmatrix's eight row addresses fall on distinct banks)
__host__ __device__ constexpr int mma_kp(int R, int A) { return (3 * R + A + 15) & ~15; }
__host__ __device__ constexpr int mma_ld(int R, int A) { return mma_kp(R, A) + 8; }

// tanh(a) * sigmoid(b) in f32, in every variant: tanhf and expf (2 ulp
// each) and a 2-ulp divide, so z is within a few ulp of the exact gate
// (__fdividef returns 0 for a divisor above 2^126, b < -87.3, where z is
// below f32's smallest normal)
__device__ __forceinline__ float gate(float a, float b) {
  return __fdividef(tanhf(a), 1.f + expf(-b));
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
      z[i] = round_to<T>(gate(acc_a[i][j], acc_b[i][j]));
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

// The block's weights into shared memory, once per block of threads: the
// gate weight as kGateRows rows of kp (<= kMaxKp) features `ld` apart (gate
// column n's row: the a-half at n < kMaxHalf, the b-half above; zeros past
// G/2 and past 3R + A), Wo as [o][k] rows (kOMajor, the mma layout) or
// [k][o] rows, `out_ld` apart, and the gate and out biases in f32 (zeros
// past G/2, R). A warp takes four gate columns at a time, its lanes
// walking the features (along the vocoder's weights' contiguous stride).
// Each lane works out its nine features' sources and column strides once,
// so a load costs one multiply-add (selects and 64-bit products for each
// element make this loop bound by instructions, at 8 warps an SM); it has
// 36 loads in flight before it stores any, and every load reads a
// valid address (a masked one reads the out bias), so none waits on a
// branch. Each block of threads starts at its own column (rotated by its
// index), so the blocks of a grid, all loading at once, spread their reads
// over the weights' lines instead of all asking for the same few.
constexpr int kMaxKp = 288;  // nine steps of 32 lanes: kp <= 288
template <typename T, typename S, bool kOMajor>
__device__ __forceinline__ void stage_weights(const PdBlockWeights& w, int R,
                                              int A, int G2, int kp, int ld,
                                              int out_ld, S* wg, S* wo,
                                              float* bg, float* bo) {
  constexpr int kWarps = kThreads / 32, kSteps = kMaxKp / 32, kPair = 4;
  static_assert(kGateRows % (kPair * kWarps) == 0 && kMaxR % kWarps == 0,
                "stage_weights' row walk");
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int KIN = 3 * R + A;
  const T* safe = static_cast<const T*>(w.bo);
  const int blk = blockIdx.x + blockIdx.y * gridDim.x;
  const int rot = blk * kPair % kGateRows;
  // the lane's features k = lane + 32 st: each one's source at gate
  // column 0 and its stride over the columns (a masked one: the out bias,
  // stride 0)
  const T* src0[kSteps];
  long long so[kSteps];
#pragma unroll
  for (int st = 0; st < kSteps; ++st) {
    const int k = lane + 32 * st;
    const int tap = (k >= R) + (k >= 2 * R);
    const bool aux = k >= 3 * R;
    const T* base = static_cast<const T*>(
        aux ? w.wa : tap == 0 ? w.w[0] : tap == 1 ? w.w[1] : w.w[2]);
    const long long si = aux ? w.wa_si : tap == 0 ? w.w_si[0]
                       : tap == 1 ? w.w_si[1] : w.w_si[2];
    const long long s_o = aux ? w.wa_so : tap == 0 ? w.w_so[0]
                        : tap == 1 ? w.w_so[1] : w.w_so[2];
    const bool ok = k < KIN;
    src0[st] = ok ? base + (aux ? k - 3 * R : k - tap * R) * si : safe;
    so[st] = ok ? s_o : 0;
  }
  for (int i0 = kPair * warp; i0 < kGateRows; i0 += kPair * kWarps) {
    const int n0 = (i0 + rot) % kGateRows;
    float v[kPair][kSteps];
#pragma unroll
    for (int h = 0; h < kPair; ++h) {
      const int n = n0 + h, half = n >= kMaxHalf, j = n - half * kMaxHalf;
      const long long o = j < G2 ? (long long)half * G2 + j : 0;
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        const float e = to_f32(src0[st][o * so[st]]);
        v[h][st] = j < G2 ? e : 0.f;
      }
    }
#pragma unroll
    for (int h = 0; h < kPair; ++h)
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        const int k = lane + 32 * st;
        if (k < kp) wg[(n0 + h) * ld + k] = from_f32<S>(v[h][st]);
      }
  }
  // Wo (G/2, R) element (k, o): a warp takes eight o, its lanes walking k
  {
    const int rot_o = blk % kMaxR;
    constexpr int kRowsAWarp = kMaxR / kWarps, kKSteps = kMaxHalf / 32;
    float v[kRowsAWarp][kKSteps];
#pragma unroll
    for (int r = 0; r < kRowsAWarp; ++r)
#pragma unroll
      for (int st = 0; st < kKSteps; ++st) {
        const int o = (warp + kWarps * r + rot_o) % kMaxR, k = lane + 32 * st;
        const bool ok = o < R && k < G2;
        const float e = to_f32(*(ok ? static_cast<const T*>(w.wo) + k * w.wo_si +
                                          o * w.wo_so
                                    : safe));
        v[r][st] = ok ? e : 0.f;
      }
#pragma unroll
    for (int r = 0; r < kRowsAWarp; ++r)
#pragma unroll
      for (int st = 0; st < kKSteps; ++st) {
        const int o = (warp + kWarps * r + rot_o) % kMaxR, k = lane + 32 * st;
        wo[kOMajor ? o * out_ld + k : k * out_ld + o] = from_f32<S>(v[r][st]);
      }
  }
  for (int n = threadIdx.x; n < kGateRows + kMaxR; n += kThreads) {
    if (n < kGateRows) {
      const int half = n / kMaxHalf, j = n % kMaxHalf;
      bg[n] = j < G2 ? gate_bias<T>(w, half * G2 + j) : 0.f;
    } else {
      const int o = n - kGateRows;
      bo[o] = o < R ? to_f32(static_cast<const T*>(w.bo)[o]) : 0.f;
    }
  }
}

// The block on one warp's 16 rows on the tensor cores: mma.sync m16n8k16,
// bf16 operands, f32 sums (bf16 products are exact in f32: the TPU
// kernel's arithmetic). The gate weight `wg` ([kGateRows][ld], kp features
// a row), Wo (`wo`, [kMaxR][kOutLd]) and the biases are in shared memory as
// stage_weights<., bf16, true> lays them out. The warp takes its 16 rows by
// all G gate columns (a-half and b-half paired in one thread), so the gate
// runs on the accumulators in registers, and z, rounded to bf16, is already
// the out product's A operand (the C fragments of two n8 tiles are the A
// fragment of one k16 step): z never touches shared memory. The caller
// gives
//   a_addr(kc)           the lane's ldmatrix address of the A operand: row
//                        lane % 16 of the warp's rows, features kc + 8 *
//                        (lane / 16) .. + 7 (16 bytes of bf16), the
//                        features in the order [x[m] | x[t] | x[p] | c | 0]
//   resid(rr, o)         the residual x[t] of row rr (0-15) at columns o,
//                        o + 1, as a float2
//   store(rr, o, v0, v1) row rr's outputs o, o + 1 before their cast.
// The k16 steps run in order with the gate bias as the accumulators' first
// value; each step's fragments are loaded while the previous step's
// products run.
template <typename AAddr, typename Resid, typename Store>
__device__ __forceinline__ void mma_block_rows(const bf16* wg, int ld, int kp,
                                               const bf16* wo,
                                               const float* bg_s,
                                               const float* bo_s, int R,
                                               int G2, const AAddr& a_addr,
                                               const Resid& resid,
                                               const Store& store) {
  const int lane = threadIdx.x % 32, g = lane >> 2, q = lane & 3;
  const bf16* brow = wg + ((lane >> 4) * 8 + (lane & 7)) * ld + ((lane >> 3) & 1) * 8;
  const bf16* orow = wo + ((lane >> 4) * 8 + (lane & 7)) * kOutLd + ((lane >> 3) & 1) * 8;

  // the gate product: n8 tiles 0-7 the a-half, 8-15 the b-half
  float acc[16][4];
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const float b0 = bg_s[nt * 8 + 2 * q], b1 = bg_s[nt * 8 + 2 * q + 1];
    acc[nt][0] = b0; acc[nt][1] = b1; acc[nt][2] = b0; acc[nt][3] = b1;
  }
  uint32_t fa[2][4], fb[2][16][2];
  auto frags = [&](int kc, uint32_t (&a)[4], uint32_t (&bb)[16][2]) {
    ldsm_x4(a, a_addr(kc));
#pragma unroll
    for (int nt = 0; nt < 16; nt += 2) {
      uint32_t r[4];
      ldsm_x4(r, brow + nt * 8 * ld + kc);
      bb[nt][0] = r[0]; bb[nt][1] = r[1];
      bb[nt + 1][0] = r[2]; bb[nt + 1][1] = r[3];
    }
  };
  auto products = [&](const uint32_t (&a)[4], const uint32_t (&bb)[16][2]) {
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) mma_bf16(acc[nt], a, bb[nt][0], bb[nt][1]);
  };
  frags(0, fa[0], fb[0]);
  int kc = 0;
  for (; kc + 32 <= kp; kc += 32) {
    frags(kc + 16, fa[1], fb[1]);
    products(fa[0], fb[0]);
    if (kc + 32 < kp) frags(kc + 32, fa[0], fb[0]);
    products(fa[1], fb[1]);
  }
  if (kc < kp) products(fa[0], fb[0]);

  // the gate on the accumulators, z rounded to bf16 into A fragments
  uint32_t zf[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int nt = 2 * ks + h;
      zf[ks][2 * h] = pack_bf16(gate(acc[nt][0], acc[nt + 8][0]),
                                gate(acc[nt][1], acc[nt + 8][1]));
      zf[ks][2 * h + 1] = pack_bf16(gate(acc[nt][2], acc[nt + 8][2]),
                                    gate(acc[nt][3], acc[nt + 8][3]));
    }
  }
  // the out product
  float out[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[nt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    if (ks * 16 >= G2) break;
    uint32_t r[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; nt += 2) ldsm_x4(r[nt / 2], orow + nt * 8 * kOutLd + ks * 16);
#pragma unroll
    for (int nt = 0; nt < 8; nt += 2) {
      mma_bf16(out[nt], zf[ks], r[nt / 2][0], r[nt / 2][1]);
      mma_bf16(out[nt + 1], zf[ks], r[nt / 2][2], r[nt / 2][3]);
    }
  }
  // bias, residual, scale
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int o = nt * 8 + 2 * q;
    if (o >= R) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 r = resid(g + 8 * h, o);
      const float v0 = out[nt][2 * h] + bo_s[o];
      const float v1 = out[nt][2 * h + 1] + bo_s[o + 1];
      store(g + 8 * h, o, (v0 + r.x) * kSqrtHalf, (v1 + r.y) * kSqrtHalf);
    }
  }
}

}  // namespace
