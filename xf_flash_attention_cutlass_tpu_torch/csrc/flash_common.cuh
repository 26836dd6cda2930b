// Shared pieces of the dense flash-attention kernels (flash_fwd.cu: K7,
// flash_probs.cu: K8, flash_bwd.cu: K9/K10/K11): the warp-level tensor-core
// product, fragment loads from shared memory, tile copies, the mask and ALiBi
// distance of one (query, key) pair, the tile skip for explicit positions and
// segment ids, the counter-based dropout mask and the elementwise recompute
// of the backward.
//
// Products use mma.sync.m16n8k16 (bf16 or fp16 inputs, f32 sums). Fragment
// layouts (PTX ISA, "Matrix fragments for mma.m16n8k16"), with g = lane / 4 and
// t = 2 * (lane % 4):
//   A 16x16, row-major: reg0 (g, t..t+1), reg1 (g+8, t..t+1), reg2 (g, t+8..t+9),
//     reg3 (g+8, t+8..t+9);
//   B 16x8 (k x n): reg0 (k = t..t+1, n = g), reg1 (k = t+8..t+9, n = g);
//   C 16x8 f32: c0, c1 at (g, t), (g, t+1); c2, c3 at (g+8, t), (g+8, t+1).
// Each register holds two consecutive k elements, the lower k in the low half.
// So a C tile pair (n-tiles 2i and 2i+1) is exactly the A fragment of k-chunk
// i: scores and probabilities feed the next product from registers.
//
// Shared-memory tiles of the mma.sync kernels (K8, K9) are stored so that
// every fragment pair is one aligned 32-bit word: an A operand row-major over
// its k index, a B operand n-major ("k contiguous"). Where a tensor is the B
// operand along its rows (K in K9's dS K), the copy into shared memory
// transposes it. Row strides carry 8 elements of padding, which spreads the
// fragment loads of one warp over all 32 banks. K7, K10 and K11 take their
// tiles by TMA and multiply with wgmma (hopper.cuh) and use only the mask,
// dropout and recompute pieces here.
#pragma once

#include <math.h>
#include <string.h>

#include "common.cuh"

namespace flash {

constexpr int kThreads = 128;  // 4 warps
constexpr int kPad = 8;        // elements of padding per shared-memory row
// masked scores: finite, so exp(NEG_INF - m) is exactly 0 for any m >= M_FLOOR
constexpr float kNegInf = -0.7f * 3.4028234663852886e38f;
constexpr float kMFloor = -1e30f;  // floor of the running max

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  __device__ __forceinline__ static void run(float c[4], const uint32_t a[4],
                                             const uint32_t b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    uint32_t r;
    memcpy(&r, &v, 4);
    return r;
  }
  __device__ __forceinline__ static __nv_bfloat16 from_float(float x) {
    return __float2bfloat16_rn(x);
  }
};

template <>
struct Mma<__half> {
  __device__ __forceinline__ static void run(float c[4], const uint32_t a[4],
                                             const uint32_t b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    uint32_t r;
    memcpy(&r, &v, 4);
    return r;
  }
  __device__ __forceinline__ static __half from_float(float x) { return __float2half_rn(x); }
};

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *static_cast<const uint32_t*>(p);
}

// A fragment of the 16x16 tile at p, row-major with row stride ld.
template <typename T>
__device__ __forceinline__ void load_a(uint32_t a[4], const T* p, int ld, int lane) {
  const int g = lane >> 2, t = (lane & 3) * 2;
  a[0] = ld32(p + g * ld + t);
  a[1] = ld32(p + (g + 8) * ld + t);
  a[2] = ld32(p + g * ld + t + 8);
  a[3] = ld32(p + (g + 8) * ld + t + 8);
}

// B fragment of the 16x8 (k x n) tile at p, stored n-major: (k, n) at p[n*ld + k].
template <typename T>
__device__ __forceinline__ void load_b(uint32_t b[2], const T* p, int ld, int lane) {
  const int g = lane >> 2, t = (lane & 3) * 2;
  b[0] = ld32(p + g * ld + t);
  b[1] = ld32(p + g * ld + t + 8);
}

// The A fragment of k-chunk i from two f32 C tiles (n-tiles 2i, 2i+1).
template <typename T>
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float c0[4], const float c1[4]) {
  a[0] = Mma<T>::pack(c0[0], c0[1]);
  a[1] = Mma<T>::pack(c0[2], c0[3]);
  a[2] = Mma<T>::pack(c1[0], c1[1]);
  a[3] = Mma<T>::pack(c1[2], c1[3]);
}

// Copy rows [row0, row0 + R) of a (n_rows, D) tensor with row stride src_ld
// (elements, a multiple of 8; the last dimension contiguous) into dst (row
// stride ld), zero-filling rows past n_rows. 16-byte loads, all of a thread's
// issued before its first store: with a runtime stride the compiler does not
// batch them itself (K9 ran about a fifth slower with a load-store loop, on an
// H100).
template <typename T, int D, int R>
__device__ __forceinline__ void load_rows(uint4 (&val)[R * D / 8 / kThreads], const T* src,
                                          int row0, int n_rows, int64_t src_ld, int& r0, int& c) {
  constexpr int kPerRow = D / 8, kStep = kThreads / kPerRow;
  static_assert(kThreads % kPerRow == 0 && R % kStep == 0, "whole rows per pass");
  r0 = threadIdx.x / kPerRow;
  c = (threadIdx.x % kPerRow) * 8;
  const T* s = src + (row0 + r0) * src_ld + c;
#pragma unroll
  for (int k = 0; k < R / kStep; ++k) {
    val[k] = make_uint4(0, 0, 0, 0);
    if (row0 + r0 + k * kStep < n_rows)
      val[k] = *reinterpret_cast<const uint4*>(s + k * kStep * src_ld);
  }
}

template <typename T, int D, int R>
__device__ __forceinline__ void copy_rows(T* dst, int ld, const T* src, int row0, int n_rows,
                                          int64_t src_ld = D) {
  constexpr int kStep = kThreads / (D / 8);
  uint4 val[R / kStep];
  int r0, c;
  load_rows<T, D, R>(val, src, row0, n_rows, src_ld, r0, c);
#pragma unroll
  for (int k = 0; k < R / kStep; ++k)
    *reinterpret_cast<uint4*>(dst + (r0 + k * kStep) * ld + c) = val[k];
}

// The same rows stored transposed: element (r, c) goes to dst[c * ld + r].
template <typename T, int D, int R>
__device__ __forceinline__ void copy_rows_t(T* dst, int ld, const T* src, int row0, int n_rows,
                                            int64_t src_ld = D) {
  constexpr int kStep = kThreads / (D / 8);
  uint4 val[R / kStep];
  int r0, c;
  load_rows<T, D, R>(val, src, row0, n_rows, src_ld, r0, c);
#pragma unroll
  for (int k = 0; k < R / kStep; ++k) {
    const T* e = reinterpret_cast<const T*>(&val[k]);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c + j) * ld + r0 + k * kStep] = e[j];
  }
}

// Options beyond the masks, shared by K7, K8 and K9-K11 (XfaExtras in
// ops/flash_fwd.py). Every pointer may be null.
//   alibi (b, h) f32 slopes, or row_slopes (b, h, sq) f32 per query row: the
//     score loses slope * |qpos - kpos| after the softcap (not scaled);
//   qpos (b, sq), kpos (b, sk) int32: explicit positions for the window masks
//     and the ALiBi distance (default: query row i at i + sk - sq, key j at j);
//   qtiles (b, ceil(sq / 64), 4), ktiles (b, ceil(sk / 64), 4) int32: the
//     least and largest position and segment id of every 64-row (64-key) tile,
//     so a kernel skips the tile pairs that cannot meet;
//   dropout: keep an entry iff dropout_bits(seed, b, q head, row, col) >=
//     drop_thresh (0: keep all); O, dV and dP carry drop_scale = 1 / (1 - p).
struct XfaExtras {
  const float* alibi;
  const float* row_slopes;
  const int32_t* qpos;
  const int32_t* kpos;
  const int32_t* qtiles;
  const int32_t* ktiles;
  unsigned long long seed;
  uint32_t drop_thresh;
  float drop_scale;
};

constexpr int kTile = 64;  // rows / keys of one entry of qtiles / ktiles

// Whether the kernels need their general instantiation for these options.
inline bool has_extras(const XfaExtras& ex) {
  return ex.alibi != nullptr || ex.row_slopes != nullptr || ex.qpos != nullptr ||
         ex.qtiles != nullptr || ex.drop_thresh != 0 || ex.drop_scale != 1.f;
}

// Philox4x32-10 (Salmon et al., SC'11; curand's philox4x32_10): four 32-bit
// words from a 128-bit counter and a 64-bit key. ops/flash_fwd.py's
// dropout_bits computes the same words in torch.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

// Dropout's random words for the entries (row, col & ~3) .. (row, col | 3):
// Philox on the counter (col / 4, row, q head, batch) under the seed; entry
// col takes word col % 4. Keyed by the entry, not by a tile, so every kernel
// replays the same mask whatever its tiling.
__device__ __forceinline__ uint4 dropout_words(const XfaExtras& ex, int ib, int ih, int row,
                                               int col) {
  return philox4x32_10(make_uint4(static_cast<uint32_t>(col) >> 2, static_cast<uint32_t>(row),
                                  static_cast<uint32_t>(ih), static_cast<uint32_t>(ib)),
                       static_cast<uint32_t>(ex.seed), static_cast<uint32_t>(ex.seed >> 32));
}

// Dropout keep bits of the entries (row, col) and (row, col + 1), col even.
__device__ __forceinline__ void dropout_keep2(const XfaExtras& ex, int ib, int ih, int row,
                                              int col, bool& keep0, bool& keep1) {
  const uint4 w = dropout_words(ex, ib, ih, row, col);
  const bool hi = (col & 2) != 0;
  keep0 = (hi ? w.z : w.x) >= ex.drop_thresh;
  keep1 = (hi ? w.w : w.y) >= ex.drop_thresh;
}

// The keep bit of the single entry (row, col).
__device__ __forceinline__ bool dropout_keep(const XfaExtras& ex, int ib, int ih, int row,
                                             int col) {
  const uint4 w = dropout_words(ex, ib, ih, row, col);
  const int c = col & 3;
  return (c == 0 ? w.x : c == 1 ? w.y : c == 2 ? w.z : w.w) >= ex.drop_thresh;
}

// Masking geometry of one (batch, head): bottom-right aligned, query row i at
// position i + offset (offset = sk - sq) unless qpos / kpos give positions;
// wl / wr < 0 are unbounded (causal is wr = 0); keys at or past kv_len (<= sk)
// are masked; segment ids, when given, must match.
struct Mask {
  int sq, sk, offset, wl, wr, kv_len;
  const int32_t* qseg;  // (sq,) of this batch row, or null
  const int32_t* kseg;  // (sk,)
  const int32_t* qpos;  // (sq,) of this batch row, or null
  const int32_t* kpos;  // (sk,)

  __device__ __forceinline__ int qp(int qi) const {
    return qpos != nullptr ? qpos[min(qi, sq - 1)] : qi + offset;
  }
  __device__ __forceinline__ int kp(int kj) const {
    return kpos != nullptr ? kpos[min(kj, sk - 1)] : kj;
  }

  __device__ __forceinline__ bool keep(int qi, int kj) const {
    if (qi >= sq || kj >= kv_len) return false;
    const int q = qp(qi), k = kp(kj);
    if (wr >= 0 && k > q + wr) return false;
    if (wl >= 0 && k < q - wl) return false;
    if (qseg != nullptr && qseg[qi] != kseg[kj]) return false;
    return true;
  }

  // |qpos - kpos| as ALiBi reads it (in float: padded positions may be far apart)
  __device__ __forceinline__ float dist(int qi, int kj) const {
    return fabsf(static_cast<float>(qp(qi)) - static_cast<float>(kp(kj)));
  }

  // Keys [lo, hi) that query rows [q0, q1) can see: tiles outside are never
  // loaded (the TPU kernel's live-pair table). With explicit positions the
  // index geometry says nothing: every key below kv_len, and the tile tables
  // skip the rest.
  __device__ __forceinline__ void key_range(int q0, int q1, int& lo, int& hi) const {
    lo = 0;
    hi = kv_len;
    if (qpos != nullptr) return;
    if (wr >= 0) hi = min(hi, q1 - 1 + offset + wr + 1);
    if (wl >= 0) lo = max(lo, q0 + offset - wl);
  }

  // Query rows [lo, hi) that can see any of keys [k0, k1).
  __device__ __forceinline__ void query_range(int k0, int k1, int& lo, int& hi) const {
    lo = 0;
    hi = sq;
    k1 = min(k1, kv_len);
    if (k0 >= k1) {
      hi = 0;
      return;
    }
    if (qpos != nullptr) return;
    if (wr >= 0) lo = max(lo, k0 - offset - wr);
    if (wl >= 0) hi = min(hi, k1 - 1 - offset + wl + 1);
  }
};

__device__ __forceinline__ Mask make_mask(int ib, int sq, int sk, int wl, int wr,
                                          const int32_t* kv_lens, const int32_t* qseg,
                                          const int32_t* kseg, const XfaExtras& ex) {
  Mask m;
  m.sq = sq;
  m.sk = sk;
  m.offset = sk - sq;
  m.wl = wl;
  m.wr = wr;
  m.kv_len = kv_lens != nullptr ? max(0, min(sk, kv_lens[ib])) : sk;
  m.qseg = qseg != nullptr ? qseg + static_cast<size_t>(ib) * sq : nullptr;
  m.kseg = kseg != nullptr ? kseg + static_cast<size_t>(ib) * sk : nullptr;
  m.qpos = ex.qpos != nullptr ? ex.qpos + static_cast<size_t>(ib) * sq : nullptr;
  m.kpos = ex.kpos != nullptr ? ex.kpos + static_cast<size_t>(ib) * sk : nullptr;
  return m;
}

// Whether the query tile holding row q0 and the key tile holding key k0 can
// hold a visible pair, from the tile tables (true without them).
__device__ __forceinline__ bool tiles_meet(const XfaExtras& ex, const Mask& m, int ib, int q0,
                                           int k0) {
  if (ex.qtiles == nullptr) return true;
  const int nqt = (m.sq + kTile - 1) / kTile, nkt = (m.sk + kTile - 1) / kTile;
  const int32_t* qt = ex.qtiles + (static_cast<size_t>(ib) * nqt + q0 / kTile) * 4;
  const int32_t* kt = ex.ktiles + (static_cast<size_t>(ib) * nkt + k0 / kTile) * 4;
  if (m.wr >= 0 && kt[0] > qt[1] + m.wr) return false;
  if (m.wl >= 0 && kt[1] < qt[0] - m.wl) return false;
  return kt[2] <= qt[3] && kt[3] >= qt[2];  // segment ranges overlap
}

// Whether every entry of (query rows [r0, r0 + 64), keys [k0, k0 + 64)) that
// a valid row holds is visible: then the tile pair needs no per-entry mask
// (K7, K10, K11). With explicit positions or segment ids only the tile
// tables can tell, so without them (or outside kExtra) such a pair is a
// boundary pair.
template <bool kExtra>
__device__ __forceinline__ bool tile_interior(const Mask& m, const XfaExtras& ex, int ib, int r0,
                                              int k0) {
  if (k0 + kTile > m.kv_len) return false;
  if (m.qseg != nullptr || m.qpos != nullptr) {
    if (!kExtra || ex.qtiles == nullptr) return false;
    const int nqt = (m.sq + kTile - 1) / kTile, nkt = (m.sk + kTile - 1) / kTile;
    const int32_t* qt = ex.qtiles + (static_cast<size_t>(ib) * nqt + r0 / kTile) * 4;
    const int32_t* kt = ex.ktiles + (static_cast<size_t>(ib) * nkt + k0 / kTile) * 4;
    if (m.qseg != nullptr && !(qt[2] == qt[3] && kt[2] == kt[3] && qt[2] == kt[2])) return false;
    if (m.qpos != nullptr) {
      if (m.wr >= 0 && kt[1] > qt[0] + m.wr) return false;
      if (m.wl >= 0 && kt[0] < qt[1] - m.wl) return false;
      return true;
    }
  }
  if (m.wr >= 0 && k0 + kTile - 1 > r0 + m.offset + m.wr) return false;
  if (m.wl >= 0 && k0 < r0 + kTile - 1 + m.offset - m.wl) return false;
  return true;
}

// The ALiBi slope of query row qi of (ib, ih), or 0 without ALiBi.
__device__ __forceinline__ float alibi_slope(const XfaExtras& ex, int ib, int ih, int h, int sq,
                                             int qi) {
  const size_t bh = static_cast<size_t>(ib) * h + ih;
  if (ex.alibi != nullptr) return ex.alibi[bh];
  if (ex.row_slopes != nullptr) return ex.row_slopes[bh * sq + min(qi, sq - 1)];
  return 0.f;
}

// LSE as the backward reads it: rows that saw no key (-inf) give P = 0.
__device__ __forceinline__ float safe_lse(float lse) { return isfinite(lse) ? lse : 3.0e38f; }

// The backward's recompute of one score, shared by K9, K10 and K11: from the
// raw product s_raw = q.k and dp = dO.v, S = s_raw * scale (tanh softcap)
// minus the ALiBi bias, P = exp(S - LSE) and dS = P (dP z - Delta) (times the
// softcap's tanh derivative) times the scale, where z is 0 for an entry the
// dropout dropped and 1 / (1 - p) otherwise (1 without dropout). p_dv = P z
// is the probability the dV product takes.
__device__ __forceinline__ void recompute_p_ds(float s_raw, float dp, float lse, float delta,
                                               bool keep, float scale, float softcap,
                                               float bias, float z, float& p_dv, float& ds) {
  float s = s_raw * scale;
  float dtanh = 1.f;
  if (softcap > 0.f) {
    const float th = tanhf(s / softcap);
    s = th * softcap;
    dtanh = 1.f - th * th;
  }
  s -= bias;
  const float p = keep ? expf(s - lse) : 0.f;
  ds = p * (dp * z - delta);
  if (softcap > 0.f) ds *= dtanh;
  ds *= scale;
  p_dv = p * z;
}

}  // namespace flash
