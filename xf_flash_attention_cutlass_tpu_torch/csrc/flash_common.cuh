// Shared pieces of the dense flash-attention kernels (flash_fwd.cu: K7,
// flash_bwd.cu: K9/K10/K11): the warp-level tensor-core product, fragment
// loads from shared memory, tile copies, the mask of one (query, key) pair and
// the elementwise recompute of the backward.
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
// Shared-memory tiles are stored so that every fragment pair is one aligned
// 32-bit word: an A operand row-major over its k index, a B operand n-major
// ("k contiguous"). Where a tensor is the B operand along its rows (V in P.V,
// K in dS.K, Q and dO in the dK/dV products), the copy into shared memory
// transposes it. Row strides carry 8 elements of padding, which spreads the
// fragment loads of one warp over all 32 banks.
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

// Copy rows [row0, row0 + R) of a (n_rows, D) row-major tensor into dst
// (row stride ld), zero-filling rows past n_rows. 16-byte loads.
template <typename T, int D, int R>
__device__ __forceinline__ void copy_rows(T* dst, int ld, const T* src, int row0, int n_rows) {
  constexpr int kVec = 8;  // elements per 16 bytes
  for (int i = threadIdx.x; i < R * (D / kVec); i += kThreads) {
    const int r = i / (D / kVec), c = (i % (D / kVec)) * kVec;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// The same rows stored transposed: element (r, c) goes to dst[c * ld + r].
template <typename T, int D, int R>
__device__ __forceinline__ void copy_rows_t(T* dst, int ld, const T* src, int row0, int n_rows) {
  constexpr int kVec = 8;
  for (int i = threadIdx.x; i < R * (D / kVec); i += kThreads) {
    const int r = i / (D / kVec), c = (i % (D / kVec)) * kVec;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * D + c);
    const T* e = reinterpret_cast<const T*>(&val);
#pragma unroll
    for (int j = 0; j < kVec; ++j) dst[(c + j) * ld + r] = e[j];
  }
}

// Masking geometry of one (batch, head): bottom-right aligned, query row i at
// position i + offset (offset = sk - sq); wl / wr < 0 are unbounded (causal
// is wr = 0); keys at or past kv_len (<= sk) are masked; segment ids, when
// given, must match.
struct Mask {
  int sq, offset, wl, wr, kv_len;
  const int32_t* qseg;  // (sq,) of this batch row, or null
  const int32_t* kseg;  // (sk,)

  __device__ __forceinline__ bool keep(int qi, int kj) const {
    if (qi >= sq || kj >= kv_len) return false;
    const int qp = qi + offset;
    if (wr >= 0 && kj > qp + wr) return false;
    if (wl >= 0 && kj < qp - wl) return false;
    if (qseg != nullptr && qseg[qi] != kseg[kj]) return false;
    return true;
  }

  // Keys [lo, hi) that query rows [q0, q1) can see: tiles outside are never
  // loaded (the TPU kernel's live-pair table).
  __device__ __forceinline__ void key_range(int q0, int q1, int& lo, int& hi) const {
    lo = 0;
    hi = kv_len;
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
    if (wr >= 0) lo = max(lo, k0 - offset - wr);
    if (wl >= 0) hi = min(hi, k1 - 1 - offset + wl + 1);
  }
};

__device__ __forceinline__ Mask make_mask(int ib, int sq, int sk, int wl, int wr,
                                          const int32_t* kv_lens, const int32_t* qseg,
                                          const int32_t* kseg) {
  Mask m;
  m.sq = sq;
  m.offset = sk - sq;
  m.wl = wl;
  m.wr = wr;
  m.kv_len = kv_lens != nullptr ? max(0, min(sk, kv_lens[ib])) : sk;
  m.qseg = qseg != nullptr ? qseg + static_cast<size_t>(ib) * sq : nullptr;
  m.kseg = kseg != nullptr ? kseg + static_cast<size_t>(ib) * sk : nullptr;
  return m;
}

// LSE as the backward reads it: rows that saw no key (-inf) give P = 0.
__device__ __forceinline__ float safe_lse(float lse) { return isfinite(lse) ? lse : 3.0e38f; }

// The backward's recompute of one score, shared by K9, K10 and K11: from the
// raw product s_raw = q.k and dp = dO.v, P = exp(s - LSE) and
// dS = P (dP - Delta) (times the softcap's tanh derivative) times the scale.
__device__ __forceinline__ void recompute_p_ds(float s_raw, float dp, float lse, float delta,
                                               bool keep, float scale, float softcap, float& p,
                                               float& ds) {
  float s = s_raw * scale;
  float dtanh = 1.f;
  if (softcap > 0.f) {
    const float th = tanhf(s / softcap);
    s = th * softcap;
    dtanh = 1.f - th * th;
  }
  p = keep ? expf(s - lse) : 0.f;
  ds = p * (dp - delta);
  if (softcap > 0.f) ds *= dtanh;
  ds *= scale;
}

}  // namespace flash
