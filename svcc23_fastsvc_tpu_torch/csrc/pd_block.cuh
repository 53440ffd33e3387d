// The gated residual block of the HN-uSFGAN vocoder: its weights' layout
// (PdBlockWeights), the gate, the in-kernel weight load, the block on one
// warp's rows on the tensor cores, and the two persistent walks over row
// tiles that the per-block kernels (pd_block.cu) and the fused chain of
// fixed blocks (pd_chain.cu) both run. Channels-last (B, T, R) stream x and
// (B, T, A) conditioning c:
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
// A walk applies one block to a list of row tiles, loading the block's
// weights into shared memory once (stage_weights) and keeping the next
// tile's rows in flight while one computes: `mma_walk` (bf16, both products
// on the tensor cores through `mma_block_rows`) or `ffma_walk` (f32 FFMA,
// and bf16 widened). Both hold the whole gate weight in shared memory, so
// they take R <= 64, G <= 128 and 3R + A <= 272 (kMaxR, kMaxHalf,
// kMaxFeatures); `wide_walk` takes any widths, streaming the weights
// through shared memory in chunks for every tile. A tile (PdTile) says where its input rows are read and
// where its output rows go, so one walk runs a block kernel's tiles of x ->
// y and a chain stage's tiles of one scratch stream -> the next: a chain
// gives the per-block kernels' bits in both dtypes because it runs their
// code. Which walk runs is ops/pd_block.py::block_plan's variant.

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
// the widths the mma and ffma walks hold (wide_walk takes any)
constexpr int kMaxHalf = 64;   // G / 2 at most
constexpr int kMaxR = 64;      // R at most
constexpr int kMaxFeatures = 272;  // 3R + A at most (MAX_FEATURES)
constexpr size_t kMaxSmemBytes = 232448;  // what one block may use on the H100
constexpr float kSqrtHalf = 0.70710678118654752f;
constexpr int kGateRows = 2 * kMaxHalf;  // gate columns in shared memory
constexpr int kMmaRows = 128;  // rows of an mma group: 8 warps x 16
constexpr int kOutLd = kMaxHalf + 8;  // Wo rows [o][k] for mma, 9 16-byte units

// the variant ids the wrappers pass (ops/pd_block.py::BLOCK_VARIANTS)
enum { kPdMma = 0, kPdFfma = 1, kPdWide = 2 };

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

// ---- walks: one block over a list of row tiles ---------------------------

// A tile of a walk: nv rows of the flattened (B * T) rows from row t0 of
// utterance b, u0 = b * T + t0 (a chain's tile may run on into the next
// utterances). Its taps read the stage input's rows src + (src_off + v) * R,
// v = b' * T + s the flattened index of source row s of the row's own
// utterance b'; its outputs go to dst + (dst_off + u) * R; c's rows are
// c + u * A. A block kernel walks x -> y (offsets 0), a chain stage one
// scratch stream -> the next.
struct PdTile {
  int b, t0, nv;
  long long src_off, dst_off;
  __device__ long long u0(int T) const { return (long long)b * T + t0; }
};

// the utterance and row of the tile's row r (r < nv): with kCross (a
// chain's tiles), a row past T steps into the next utterance without a
// division; a block kernel's tiles never cross
template <bool kCross>
__device__ __forceinline__ void tile_row(const PdTile& tl, int r, int T,
                                         int& b, int& t) {
  b = tl.b;
  t = tl.t0 + r;
  if constexpr (kCross) {
    while (t >= T) {
      t -= T;
      ++b;
    }
  }
}

// What a walk reads and writes, and the block's side taps
struct PdWalk {
  const void* src;
  void* dst;
  const void* c;
  const int* shifts;  // adaptive: (B, n_frames) pitch shifts
  int T, R, A, G2, hop, n_frames, dil;
  void* zbuf;  // wide_walk: kWdRows x G2 of the stream type a block of threads
};

// the source row of tap m (hi = false) or p (hi = true) for stream row t;
// -1 reads zero
template <bool kAdaptive>
__device__ __forceinline__ int side_row(const PdWalk& w, int b, int t,
                                        bool hi) {
  if constexpr (kAdaptive) {
    // any int32 shift: in 64 bits neither tap overflows, and a tap outside
    // [0, T) reads zero, as in the plain gather
    const long long s = w.shifts[(size_t)b * w.n_frames + t / w.hop];
    const long long u = hi ? t + s : t - s;
    return u >= 0 && u < w.T ? (int)u : -1;
  } else {
    return hi ? reflect_hi(t, w.dil, w.T) : reflect_lo(t, w.dil);
  }
}

// ---- the mma walk (bf16) --------------------------------------------------
//
// pd_block.cuh's mma_block_rows, both products on the tensor cores. A tile
// is 128 rows; each row's three tap rows and its conditioning row are
// gathered into one shared row [x[m] | x[t] | x[p] | c | 0], the features
// padded with zeros to a multiple of 16: 16-byte copies for the taps, while
// c's rows (62 or 63 features, not 16-byte aligned) come in as one
// contiguous run of the tile's rows and are spread into the rows in shared
// memory. The next tile's gather is in flight (cp.async, zero-filled for
// taps that read zero) while this one computes; the first tile's while the
// weights come in (stage_weights). The output goes back through the tile's
// own (dead) tap rows for 16-byte stores.

constexpr int kTapCopies = 3 * kMmaRows * 8 / kThreads;  // 16-byte units a thread
constexpr int kShiftRows = 4;  // distinct rows among a thread's tap copies
static_assert(kMmaRows == 128 && kThreads == 256, "the mma walk's row map");

// a tile's rows of c as one run of 16-byte units, from the unit holding its
// first byte
__host__ __device__ constexpr int cbuf_bytes(int A) {
  return (kMmaRows * A * 2 + 31) & ~15;
}

inline size_t mma_smem_bytes(int R, int A) {
  return (size_t)(2 * kMmaRows + kGateRows) * mma_ld(R, A) * sizeof(bf16) +
         (size_t)kMaxR * kOutLd * sizeof(bf16) +
         (size_t)(kGateRows + kMaxR) * sizeof(float) + cbuf_bytes(A);
}

// Block `wt` (a kernel parameter, read in place) on tiles(0), ..,
// tiles(n - 1) (n >= 1, the same in every thread; kCross: tiles may run on
// into the next utterances).
template <bool kAdaptive, bool kCross, typename Tiles>
__device__ __forceinline__ void mma_walk(const PdWalk& w,
                                         const PdBlockWeights& wt,
                                         const Tiles& tiles, int n,
                                         unsigned char* smem) {
  const int T_len = w.T, R = w.R, A = w.A, G2 = w.G2;
  const int KIN = 3 * R + A, KP = mma_kp(R, A), ld = mma_ld(R, A);
  bf16* stages = reinterpret_cast<bf16*>(smem);  // [2][kMmaRows][ld]
  bf16* wg = stages + 2 * kMmaRows * ld;         // [kGateRows][ld]
  bf16* wo = wg + kGateRows * ld;                // [kMaxR][kOutLd]
  float* bg_s = reinterpret_cast<float*>(wo + kMaxR * kOutLd);
  float* bo_s = bg_s + kGateRows;
  unsigned char* cbuf = reinterpret_cast<unsigned char*>(bo_s + kMaxR);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bf16* x = static_cast<const bf16*>(w.src);
  const unsigned char* cbytes = static_cast<const unsigned char*>(w.c);
  bf16* y = static_cast<bf16*>(w.dst);

  // c's bytes of a tile: [S, E) from the start of c
  auto c_range = [&](const PdTile& tl, size_t& S, size_t& E) {
    S = (size_t)tl.u0(T_len) * A * sizeof(bf16);
    E = S + (size_t)tl.nv * A * sizeof(bf16);
  };
  // the utterance (b) and row (t) of the four rows a thread copies, tid / 8
  // + 32m (copy n of a thread is tap n / 4 of row m = n % 4); rows past nv
  // are not read
  auto rows_of = [&](const PdTile& tl, int (&b)[kShiftRows],
                     int (&t)[kShiftRows]) {
#pragma unroll
    for (int m = 0; m < kShiftRows; ++m) {
      const int r = (tid >> 3) + 32 * m;
      b[m] = tl.b;
      t[m] = tl.t0 + r;
      if (kCross && r < tl.nv) tile_row<kCross>(tl, r, T_len, b[m], t[m]);
    }
  };
  // the adaptive taps' pitch shifts of a tile's rows, loaded ahead of the
  // copies that need them (taps m and p share a row's shift)
  auto shifts_of = [&](const PdTile& tl, int (&sh)[kShiftRows]) {
    if constexpr (kAdaptive) {
      int b[kShiftRows], t[kShiftRows];
      rows_of(tl, b, t);
#pragma unroll
      for (int m = 0; m < kShiftRows; ++m) {
        const int r = (tid >> 3) + 32 * m;
        sh[m] = r < tl.nv ? w.shifts[(size_t)b[m] * w.n_frames + t[m] / w.hop]
                          : 0;
      }
    }
  };
  // A tile's tap rows into stage s, 32 lanes copying four rows of one tap
  // (eight 16-byte units a row), and its c rows into cbuf as one run.
  auto gather = [&](const PdTile& tl, int s, const int (&sh)[kShiftRows]) {
    bf16* st = stages + s * kMmaRows * ld;
    int bm[kShiftRows], tm[kShiftRows];
    rows_of(tl, bm, tm);
    const bf16* xb = x + (tl.src_off + (long long)tl.b * T_len) * R;  // row 0 of b
#pragma unroll
    for (int n = 0; n < kTapCopies; ++n) {
      const int idx = tid + kThreads * n;
      const int seg = idx & 7, rt = idx >> 3;
      const int tap = rt >> 7, r = rt & (kMmaRows - 1);
      const int t = kCross ? tm[n % kShiftRows] : tl.t0 + r;
      if (seg * 8 >= R) continue;
      int src = -1;
      if (r < tl.nv) {
        if (tap == 1) {
          src = t;
        } else if constexpr (kAdaptive) {
          const long long u = tap == 2 ? (long long)t + sh[n % kShiftRows]
                                       : (long long)t - sh[n % kShiftRows];
          src = u >= 0 && u < T_len ? (int)u : -1;
        } else {
          src = tap == 2 ? reflect_hi(t, w.dil, T_len) : reflect_lo(t, w.dil);
        }
      }
      const bf16* from =
          kCross ? x + (tl.src_off + (long long)bm[n % kShiftRows] * T_len + src) * R
                 : xb + (size_t)src * R;
      cp_async16(st + r * ld + tap * R + seg * 8, src >= 0 ? from + seg * 8 : x,
                 src >= 0);
    }
    size_t S, E;
    c_range(tl, S, E);
    const size_t u0 = S >> 4;
    const int units = (int)(((E + 15) >> 4) - u0);
    for (int u = tid; u < units; u += kThreads) {
      const size_t at = (u0 + u) * 16;
      cp_async16_n(cbuf + u * 16, cbytes + at, (int)min((size_t)16, E - at));
    }
    cp_async_commit();
  };

  int sh[kShiftRows] = {};
  // the features past 3R + A of both stages (never copied) are zero
  for (int i = tid; i < 2 * kMmaRows * (KP - KIN); i += kThreads) {
    const int r = i / (KP - KIN);
    stages[r * ld + KIN + (i - r * (KP - KIN))] = __float2bfloat16(0.f);
  }
  // the first tile's rows in flight while the weights come in
  shifts_of(tiles(0), sh);
  gather(tiles(0), 0, sh);
  if (n > 1) shifts_of(tiles(1), sh);
  stage_weights<bf16, bf16, true>(wt, R, A, G2, KP, ld, kOutLd, wg, wo, bg_s,
                                  bo_s);

  int s = 0;
  PdTile next = tiles(0);
  for (int i = 0; i < n; ++i, s ^= 1) {
    const PdTile tl = next;
    if (i + 1 < n) next = tiles(i + 1);
    cp_async_wait<0>();
    __syncthreads();
    bf16* st = stages + s * kMmaRows * ld;
    // c's rows from the run into the tile's rows (zeros past nv), a warp a
    // row, 4-byte words where the run's rows start on them, else elements;
    // each thread's loads all issued before its stores
    {
      const int nv = tl.nv;
      const int off = (int)(((size_t)tl.u0(T_len) * A * 2) & 15);
      if (A % 2 == 0 && off % 4 == 0 && A <= 64) {
        const int words = A / 2;
        const uint32_t* run = reinterpret_cast<const uint32_t*>(cbuf + off);
        uint32_t v[kMmaRows / 8];
#pragma unroll
        for (int m = 0; m < kMmaRows / 8; ++m) {
          const int r = warp + 8 * m;
          v[m] = r < nv && lane < words ? run[r * words + lane] : 0u;
        }
#pragma unroll
        for (int m = 0; m < kMmaRows / 8; ++m)
          if (lane < words)
            *reinterpret_cast<uint32_t*>(st + (warp + 8 * m) * ld + 3 * R + 2 * lane) = v[m];
      } else {
        const bf16* run = reinterpret_cast<const bf16*>(cbuf + off);
        for (int r = warp; r < kMmaRows; r += kThreads / 32)
          for (int e = lane; e < A; e += 32)
            st[r * ld + 3 * R + e] = r < nv ? run[r * A + e] : __float2bfloat16(0.f);
      }
    }
    __syncthreads();
    if (i + 1 < n) gather(next, s ^ 1, sh);

    // the block on the warp's 16 rows; the residual x[t] from the rows'
    // tap-c features, the output into their (dead) tap-m features, then out
    // with 16-byte stores
    const bf16* arow = st + (warp * 16 + (lane & 15)) * ld + (lane >> 4) * 8;
    bf16* wrows = st + warp * 16 * ld;
    mma_block_rows(
        wg, ld, KP, wo, bg_s, bo_s, R, G2,
        [&](int kc) { return arow + kc; },
        [&](int rr, int o) {
          const bf16* row = wrows + rr * ld + R + o;
          return make_float2(to_f32(row[0]), to_f32(row[1]));
        },
        [&](int rr, int o, float v0, float v1) {
          *reinterpret_cast<__nv_bfloat162*>(wrows + rr * ld + o) =
              __floats2bfloat162_rn(v0, v1);
        });
    __syncwarp();
    for (int e = lane; e < 16 * 8; e += 32) {
      const int rr = e >> 3, sg = e & 7, r = warp * 16 + rr;
      if (sg * 8 < R && r < tl.nv)
        *reinterpret_cast<uint4*>(y + (tl.dst_off + tl.u0(T_len) + r) * R + sg * 8) =
            *reinterpret_cast<const uint4*>(st + r * ld + sg * 8);
    }
    if (i + 2 < n) shifts_of(tiles(i + 2), sh);
    __syncthreads();
  }
  cp_async_wait<0>();
}

// ---- the ffma walk (f32, and bf16 widened) --------------------------------
//
// True f32, FFMA, the products summed in the order of the features with the
// bias first. A tile is 256 rows; lane l of every warp owns rows l + 32i
// (i < 8) and warp w the gate pairs 8w..8w+7, a-half and b-half: 128
// accumulators, and per four features 8 row loads and 16 uniform weight
// loads (128-bit) feed 512 FMAs. The input features come in chunks of 16
// (cp.async, two stages; the next tile's first chunk while this tile's last
// computes); z goes through shared memory for the out product.

constexpr int kFfRows = 256;  // rows of a tile: 32 lanes x 8
constexpr int kFfKC = 16;     // input features per chunk
constexpr int kFfLd = kFfKC + 4;  // 80-byte stage rows
constexpr int kZLd = kMaxHalf + 4;  // z rows, 272 bytes
constexpr int kZRows = 128;   // z rows per pass (half a tile)
constexpr int kFfRowsAThread = kFfRows / (kThreads / 4);  // gathered rows

__host__ __device__ constexpr int ff_kw(int R, int A) { return (3 * R + A + 3) & ~3; }

inline size_t ffma_smem_bytes(int R, int A) {
  return ((size_t)2 * kFfRows * kFfLd + (size_t)kZRows * kZLd +
          (size_t)kGateRows * ff_kw(R, A) + (size_t)kMaxHalf * kMaxR +
          kGateRows + kMaxR) * sizeof(float);
}

template <typename T, bool kAdaptive, bool kCross, typename Tiles>
__device__ __forceinline__ void ffma_walk(const PdWalk& w,
                                          const PdBlockWeights& wt,
                                          const Tiles& tiles, int n,
                                          float* smem) {
  constexpr bool kF32 = sizeof(T) == 4;
  const int T_len = w.T, R = w.R, A = w.A, G2 = w.G2;
  const int KIN = 3 * R + A, KW = ff_kw(R, A);
  const int n_chunks = (KIN + kFfKC - 1) / kFfKC;
  float* stages = smem;                        // [2][kFfRows][kFfLd]
  float* z_s = stages + 2 * kFfRows * kFfLd;   // [kZRows][kZLd]
  float* wg = z_s + kZRows * kZLd;             // [kGateRows][KW]
  float* wo = wg + kGateRows * KW;             // [k][o], 64 x 64
  float* bg_s = wo + kMaxHalf * kMaxR;
  float* bo_s = bg_s + kGateRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* x = static_cast<const T*>(w.src);
  const T* c = static_cast<const T*>(w.c);
  T* y = static_cast<T*>(w.dst);

  // the side taps' source rows (m, p) of the thread's rows of a tile, from
  // row 0 of the tile's utterance b (past T: a later utterance's), once a
  // tile (-1 reads zero)
  auto side_rows = [&](const PdTile& tl, int (&sm)[kFfRowsAThread],
                       int (&sp)[kFfRowsAThread]) {
#pragma unroll
    for (int m = 0; m < kFfRowsAThread; ++m) {
      const int r = (tid >> 2) + (kThreads / 4) * m;
      sm[m] = sp[m] = -1;
      if (r < tl.nv) {
        int b, t;
        tile_row<kCross>(tl, r, T_len, b, t);
        const int lo = side_row<kAdaptive>(w, b, t, false);
        const int hi = side_row<kAdaptive>(w, b, t, true);
        sm[m] = lo >= 0 ? (b - tl.b) * T_len + lo : -1;
        sp[m] = hi >= 0 ? (b - tl.b) * T_len + hi : -1;
      }
    }
  };
  // chunk ch of a tile into stage s: thread copies 4-feature segment
  // tid % 4 of row tid / 4 + 64m (its side taps' rows m_src, p_src): one
  // 16-byte copy where the four features are one tap's, two 8-byte ones
  // where they are c's, in f32; the caller commits
  auto gather_row = [&](const PdTile& tl, int ch, int s, int m, int m_src,
                        int p_src) {
    // rows from row 0 of the tile's utterance b
    const T* xb = x + (tl.src_off + (long long)tl.b * T_len) * R;
    const T* cb = c + (size_t)tl.b * T_len * A;
    const int f0 = ch * kFfKC + (tid & 3) * 4;  // first feature of the segment
    const int tap = f0 < 3 * R ? f0 / R : 3;
    const int r = (tid >> 2) + (kThreads / 4) * m, t = tl.t0 + r;
    const bool ok_row = r < tl.nv;
    float* dst = stages + s * kFfRows * kFfLd + r * kFfLd + (tid & 3) * 4;
    auto tap_src = [&](int tp) {
      return !ok_row ? -1 : tp == 0 ? m_src : tp == 1 ? t : p_src;
    };
    if constexpr (kF32) {
      if (tap < 3 && R % 4 == 0) {
        const int src = tap_src(tap);
        cp_async16(dst, src >= 0 ? xb + (size_t)src * R + (f0 - tap * R) : x,
                   src >= 0);
        return;
      }
      if (tap == 3 && R % 2 == 0 && A % 2 == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int f = f0 + 2 * h;
          const bool ok = f < KIN && ok_row;
          cp_async8(dst + 2 * h, ok ? cb + (size_t)t * A + (f - 3 * R) : c, ok);
        }
        return;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int f = f0 + e;
      const T* from = nullptr;
      if (f < 3 * R) {
        const int tp = f / R, sr = tap_src(tp);
        if (sr >= 0) from = xb + (size_t)sr * R + (f - tp * R);
      } else if (f < KIN && ok_row) {
        from = cb + (size_t)t * A + (f - 3 * R);
      }
      if constexpr (kF32) cp_async4(dst + e, from != nullptr ? from : c, from != nullptr);
      else dst[e] = from != nullptr ? to_f32(*from) : 0.f;
    }
  };

  // the first chunk in flight while the weights come in
  int sm[kFfRowsAThread], sp[kFfRowsAThread];
  {
    const PdTile t0 = tiles(0);
    side_rows(t0, sm, sp);
#pragma unroll
    for (int m = 0; m < kFfRowsAThread; ++m) gather_row(t0, 0, 0, m, sm[m], sp[m]);
  }
  cp_async_commit();
  stage_weights<T, float, false>(wt, R, A, G2, KW, KW, kMaxR, wg, wo, bg_s,
                                 bo_s);
  cp_async_wait<0>();
  __syncthreads();  // the weights and biases, before the accumulators start

  const float* wa_row = wg + (8 * warp) * KW;             // a-half rows
  const float* wb_row = wg + (kMaxHalf + 8 * warp) * KW;  // b-half rows
  int s = 0;
  for (int i = 0; i < n; ++i) {
    const PdTile tl = tiles(i);
    float acc_a[8][8], acc_b[8][8];  // [row][pair jj]
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float ba = bg_s[8 * warp + jj], bb = bg_s[kMaxHalf + 8 * warp + jj];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        acc_a[r][jj] = ba;
        acc_b[r][jj] = bb;
      }
    }
    for (int ch = 0; ch < n_chunks; ++ch, s ^= 1) {
      // the next chunk: this tile's, or the next tile's first
      if (ch + 1 < n_chunks || i + 1 < n) {
        const bool same = ch + 1 < n_chunks;
        const PdTile tn = same ? tl : tiles(i + 1);
        if (!same) side_rows(tn, sm, sp);
#pragma unroll
        for (int m = 0; m < kFfRowsAThread; ++m)
          gather_row(tn, same ? ch + 1 : 0, s ^ 1, m, sm[m], sp[m]);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* st = stages + s * kFfRows * kFfLd + lane * kFfLd;
      const int k0 = ch * kFfKC;
      const int nq = min(kFfKC, KW - k0) / 4;
      for (int kq = 0; kq < nq; ++kq) {
        float4 a[8];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          a[r] = *reinterpret_cast<const float4*>(st + r * 32 * kFfLd + kq * 4);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float4 wa = *reinterpret_cast<const float4*>(wa_row + jj * KW + k0 + kq * 4);
          const float4 wb = *reinterpret_cast<const float4*>(wb_row + jj * KW + k0 + kq * 4);
          // each accumulator's four features in order, 16 FMAs apart
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            acc_a[r][jj] = fmaf(a[r].x, wa.x, acc_a[r][jj]);
            acc_b[r][jj] = fmaf(a[r].x, wb.x, acc_b[r][jj]);
          }
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            acc_a[r][jj] = fmaf(a[r].y, wa.y, acc_a[r][jj]);
            acc_b[r][jj] = fmaf(a[r].y, wb.y, acc_b[r][jj]);
          }
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            acc_a[r][jj] = fmaf(a[r].z, wa.z, acc_a[r][jj]);
            acc_b[r][jj] = fmaf(a[r].z, wb.z, acc_b[r][jj]);
          }
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            acc_a[r][jj] = fmaf(a[r].w, wa.w, acc_a[r][jj]);
            acc_b[r][jj] = fmaf(a[r].w, wb.w, acc_b[r][jj]);
          }
        }
      }
      __syncthreads();
    }

    // the gate, z rounded to the stream type; the out product in two
    // passes of 128 rows: lanes 0-15 take output columns 4l.., lanes 16-31
    // the next row, warp w rows 2w + (l >= 16) + 16i
    const int oc = (lane & 15) * 4;
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int rq = 4 * pass + q;
        float z[8];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          z[jj] = round_to<T>(gate(acc_a[rq][jj], acc_b[rq][jj]));
        float4* zp = reinterpret_cast<float4*>(z_s + (lane + 32 * q) * kZLd + 8 * warp);
        zp[0] = make_float4(z[0], z[1], z[2], z[3]);
        zp[1] = make_float4(z[4], z[5], z[6], z[7]);
      }
      __syncthreads();
      float out[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) out[r][e] = 0.f;
      const float* zr = z_s + ((lane >> 4) + 2 * warp) * kZLd;
      for (int k = 0; k < G2; k += 4) {
        float4 w4[4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          w4[kk] = *reinterpret_cast<const float4*>(wo + (k + kk) * kMaxR + oc);
        float4 z4[8];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          z4[r] = *reinterpret_cast<const float4*>(zr + 16 * r * kZLd + k);
        // each accumulator's four k in order, 32 FMAs apart
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const float zv = kk == 0 ? z4[r].x : kk == 1 ? z4[r].y
                           : kk == 2 ? z4[r].z : z4[r].w;
            out[r][0] = fmaf(zv, w4[kk].x, out[r][0]);
            out[r][1] = fmaf(zv, w4[kk].y, out[r][1]);
            out[r][2] = fmaf(zv, w4[kk].z, out[r][2]);
            out[r][3] = fmaf(zv, w4[kk].w, out[r][3]);
          }
      }
      // the residual x[t] of all eight rows first, then the outputs: a
      // load after a store to y would wait for it
      T res[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int rl = kZRows * pass + (lane >> 4) + 2 * warp + 16 * r;
        const T* xr = x + (tl.src_off + tl.u0(T_len) + min(rl, tl.nv - 1)) * R;
#pragma unroll
        for (int e = 0; e < 4; ++e) res[r][e] = xr[min(oc + e, R - 1)];
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int rl = kZRows * pass + (lane >> 4) + 2 * warp + 16 * r;
        if (rl >= tl.nv) continue;
        T* yr = y + (tl.dst_off + tl.u0(T_len) + rl) * R;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int o = oc + e;
          if (o >= R) continue;
          const float v = out[r][e] + bo_s[o];
          yr[o] = from_f32<T>((v + to_f32(res[r][e])) * kSqrtHalf);
        }
      }
      __syncthreads();
    }
  }
  cp_async_wait<0>();
}

// ---- the wide walk (any widths; f32, and bf16 widened) --------------------
//
// For blocks whose gate weight the walks above cannot hold in shared memory
// (R > 64, G > 128 or 3R + A > 272; the JAX kernels take every width). The
// same arithmetic as ffma_walk: true f32 FFMA, the gate's features summed
// in order with the bias first, z rounded to the stream type, the out
// product's G/2 terms summed in order. A tile is 64 rows. The gate runs in
// passes of 32 pairs (a thread: one pair, eight rows), each over chunks of
// 32 features of the rows [x[m] | x[t] | x[p] | c] and the matching rows of
// the gate weight, both staged in shared memory; a pass's z goes to the
// block of threads' own 64 x G/2 rows of `zbuf` (device memory, L2 in
// practice; z is already rounded to the stream type, so storing it there
// changes no bit). The out product then runs in passes of 64 output
// columns (a thread: one column, 16 rows) over chunks of 32 of z's columns
// and Wo's rows. Nothing of the widths is held whole, so nothing bounds
// them; the weights are read again for every tile, which makes this walk
// slower than the two above at the widths both take.

constexpr int kWdRows = 64;   // rows of a tile
constexpr int kWdPairs = 32;  // gate pairs of a pass
constexpr int kWdKC = 32;     // features (gate) or z columns (out) of a chunk
constexpr int kWdOC = 64;     // output columns of a pass
constexpr int kWdLd = kWdKC + 1;
static_assert(2 * kWdPairs == kWdOC && kWdRows * kWdKC == 8 * kThreads &&
                  kWdKC == 32 && kThreads == 256,
              "the wide walk's thread map");

inline size_t wide_smem_bytes() {
  return (size_t)(kWdRows * kWdLd + kWdKC * kWdOC) * sizeof(float) +
         (size_t)3 * kWdRows * sizeof(long long);
}

template <typename T, bool kAdaptive, bool kCross, typename Tiles>
__device__ __forceinline__ void wide_walk(const PdWalk& w,
                                          const PdBlockWeights& wt,
                                          const Tiles& tiles, int n,
                                          unsigned char* smem) {
  const int T_len = w.T, R = w.R, A = w.A, G2 = w.G2, KIN = 3 * R + A;
  float* in_s = reinterpret_cast<float*>(smem);  // [kWdRows][kWdLd]
  float* w_s = in_s + kWdRows * kWdLd;           // [kWdKC][kWdOC]
  long long* rows_s = reinterpret_cast<long long*>(w_s + kWdKC * kWdOC);  // [3][kWdRows]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* x = static_cast<const T*>(w.src);
  const T* c = static_cast<const T*>(w.c);
  T* y = static_cast<T*>(w.dst);
  T* z = static_cast<T*>(w.zbuf) + (size_t)blockIdx.x * kWdRows * G2;
  const T* wo = static_cast<const T*>(wt.wo);
  const T* bo = static_cast<const T*>(wt.bo);

  for (int i = 0; i < n; ++i) {
    const PdTile tl = tiles(i);
    const long long u0 = tl.u0(T_len);
    // the flattened source row of each tap of the tile's rows (-1 reads
    // zero); past nv every tap reads zero
    if (tid < kWdRows) {
      long long v[3] = {-1, -1, -1};
      if (tid < tl.nv) {
        int b, t;
        tile_row<kCross>(tl, tid, T_len, b, t);
        const int lo = side_row<kAdaptive>(w, b, t, false);
        const int hi = side_row<kAdaptive>(w, b, t, true);
        const long long row0 = (long long)b * T_len;
        v[0] = lo >= 0 ? row0 + lo : -1;
        v[1] = row0 + t;
        v[2] = hi >= 0 ? row0 + hi : -1;
      }
      for (int tap = 0; tap < 3; ++tap) rows_s[tap * kWdRows + tid] = v[tap];
    }
    __syncthreads();

    // the gate, a pass of 32 pairs at a time: lane = pair, rows warp + 8r
    for (int j0 = 0; j0 < G2; j0 += kWdPairs) {
      const int j = j0 + lane;
      float acc_a[8], acc_b[8];
      {
        const float ba = j < G2 ? gate_bias<T>(wt, j) : 0.f;
        const float bb = j < G2 ? gate_bias<T>(wt, G2 + j) : 0.f;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          acc_a[r] = ba;
          acc_b[r] = bb;
        }
      }
      for (int k0 = 0; k0 < KIN; k0 += kWdKC) {
        // feature k0 + lane of rows warp + 8m, and feature k0 + (tid / 64
        // + 4m) of gate columns tid % 64 (the a-half's 32, the b-half's)
        float a[8], wv[8];
        const int f = k0 + lane;
        const int tap = f < 3 * R ? f / R : 3;
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const int r = warp + 8 * m;
          float e = 0.f;
          if (tap < 3) {
            const long long src = rows_s[tap * kWdRows + r];
            if (src >= 0) e = to_f32(x[(tl.src_off + src) * R + (f - tap * R)]);
          } else if (f < KIN && r < tl.nv) {
            e = to_f32(c[(u0 + r) * A + (f - 3 * R)]);
          }
          a[m] = e;
        }
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const int col = tid % kWdOC, fw = k0 + tid / kWdOC + 4 * m;
          const int jj = j0 + col % kWdPairs;
          const long long gcol = (col < kWdPairs ? 0 : G2) + jj;
          float e = 0.f;
          if (jj < G2 && fw < KIN) {
            const int tp = fw < 3 * R ? fw / R : 3;
            e = tp < 3 ? to_f32(static_cast<const T*>(wt.w[tp])[
                             (fw - tp * R) * wt.w_si[tp] + gcol * wt.w_so[tp]])
                       : to_f32(static_cast<const T*>(wt.wa)[
                             (fw - 3 * R) * wt.wa_si + gcol * wt.wa_so]);
          }
          wv[m] = e;
        }
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          in_s[(warp + 8 * m) * kWdLd + lane] = a[m];
          w_s[(tid / kWdOC + 4 * m) * kWdOC + tid % kWdOC] = wv[m];
        }
        __syncthreads();
        const int nk = min(kWdKC, KIN - k0);
        for (int k = 0; k < nk; ++k) {
          const float wa = w_s[k * kWdOC + lane];
          const float wb = w_s[k * kWdOC + kWdPairs + lane];
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const float av = in_s[(warp + 8 * r) * kWdLd + k];
            acc_a[r] = fmaf(av, wa, acc_a[r]);
            acc_b[r] = fmaf(av, wb, acc_b[r]);
          }
        }
        __syncthreads();
      }
      if (j < G2) {
#pragma unroll
        for (int r = 0; r < 8; ++r)
          z[(warp + 8 * r) * G2 + j] = from_f32<T>(gate(acc_a[r], acc_b[r]));
      }
    }
    // this tile's z, stored by any thread, before the out product reads it
    __threadfence_block();
    __syncthreads();

    // the out product, a pass of 64 columns at a time: column tid % 64,
    // rows tid / 64 + 4r
    for (int o0 = 0; o0 < R; o0 += kWdOC) {
      const int o = o0 + tid % kWdOC, rq = tid / kWdOC;
      float out[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) out[r] = 0.f;
      for (int k0 = 0; k0 < G2; k0 += kWdKC) {
        float zv[8], wv[8];
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const int r = warp + 8 * m, k = k0 + lane;
          zv[m] = k < G2 ? to_f32(z[r * G2 + k]) : 0.f;
          const int kw = k0 + rq + 4 * m;
          wv[m] = kw < G2 && o < R ? to_f32(wo[kw * wt.wo_si + o * wt.wo_so]) : 0.f;
        }
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          in_s[(warp + 8 * m) * kWdLd + lane] = zv[m];
          w_s[(rq + 4 * m) * kWdOC + tid % kWdOC] = wv[m];
        }
        __syncthreads();
        const int nk = min(kWdKC, G2 - k0);
        for (int k = 0; k < nk; ++k) {
          const float wk = w_s[k * kWdOC + tid % kWdOC];
#pragma unroll
          for (int r = 0; r < 16; ++r)
            out[r] = fmaf(in_s[(rq + 4 * r) * kWdLd + k], wk, out[r]);
        }
        __syncthreads();
      }
      if (o < R) {
        const float b = to_f32(bo[o]);
        const T* xr = x + (tl.src_off + u0) * R + o;
        T* yr = y + (tl.dst_off + u0) * R + o;
        float res[16];
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const int rl = rq + 4 * r;
          res[r] = rl < tl.nv ? to_f32(xr[(long long)rl * R]) : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const int rl = rq + 4 * r;
          if (rl < tl.nv)
            yr[(long long)rl * R] = from_f32<T>((out[r] + b + res[r]) * kSqrtHalf);
        }
      }
    }
    // the tile's z and rows_s read, before the next tile writes them
    __syncthreads();
  }
}

// The shared-memory size a kernel asks for, or an error for one above what
// a block may use.
template <typename Kern>
int prepare(Kern kern, size_t smem) {
  if (smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
