// The dense flash-attention family in f32: the forward (K7), the probability
// plane (K8), dQ (K9), dK/dV (K10) and the one-pass backward (K11), on f32
// FMA. wgmma takes no f32 operands, and TF32 keeps 10 mantissa bits, too few
// to hold an f32 result to an f64 oracle, so these kernels multiply on the
// CUDA cores in full f32.
//
// Replaces, for f32 inputs, the TPU kernels of
// xf_flash_attention_cutlass_tpu/ops/flash_fwd.py `_flash_fwd_kernel` (:100)
// and `_probs_kernel` (:379), and of xf_flash_attention_cutlass_tpu/ops/
// flash_bwd.py `_dq_kernel` (:228), `_dkv_kernel` (:284) and
// `_bwd_fused_kernel` (:156). They compute what flash_fwd.cu, flash_probs.cu
// and flash_bwd.cu compute for bf16 and fp16 (see there), with the same
// blocks, block order, masks, options and dropout mask (flash_common.cuh's
// Mask, tiles_meet, tile_interior, dropout_words and recompute_p_ds), so the
// f32 dropout mask is the 16-bit kernels' mask bit for bit.
//
// Design: a block is 256 threads, 16 x 16 (ty = tid / 16, tx = tid % 16),
// over 64-row x 64-key tiles staged in shared memory from the caller's
// strided tensors (float4 loads along d; rows past the tensor are zeros).
// Tiles are kept row-major as the tensors are, rows padded by 4 floats so
// that the products read them without bank conflicts. Two register-tiled
// products serve every kernel:
//   mma_nt: a 64 x 64 score tile, A rows times B rows (S = Q K^T, dP = dO V^T,
//           S^T = K Q^T): thread (ty, tx) holds rows 4 ty + i and columns
//           tx + 16 j, so a row's 64 scores lie in 16 lanes of one warp
//           (row max and sum by four shuffles);
//   mma_nn: a 64 x D tile, A (64 x 64, row-major) times B (64 x D,
//           row-major): P V, dS K, P^T dO, dS^T Q; thread (ty, tx) holds
//           rows 4 ty + i and columns 64 g + 4 tx + e, float4 stores; with
//           kTransA, A is read transposed (K11's dQ = dS K from dS^T).
// Every product sums its inner dimension in order in one f32 FMA chain (d,
// or the 64 keys or queries of one tile); the sums over tiles are kept
// apart: each tile's part of O, dQ, dK or dV is summed from zero and then
// added to the running sum, so no single accumulator runs over 2048 keys.
// The options (softcap, ALiBi, explicit positions, segment ids, the tile
// tables, dropout) are read at run time: one instantiation per head dim
// (and K10 / K11). exp, log and tanh are the accurate expf, logf, tanhf
// (no --use_fast_math).
//
// Numerics are the plain versions' (ops/flash_fwd.py flash_fwd_ref,
// attention_probs_ref, ops/flash_bwd.py flash_bwd_ref) in f32: K7 and K8
// multiply q by the softmax scale (f32 product) before the product, the
// backward scales the raw product; masked scores are the finite NEG_INF
// with the running max floored at -1e30; P = exp(S - m); dropout zeroes P
// after the row sum, O takes 1 / (1 - p); rows that see no key give O = 0
// and LSE = -inf. Delta = rowsum(dO * O) comes from the wrapper (plain
// torch); K11 adds dQ into an f32 buffer with atomics.
//
// Bound on an H100: operations, at the f32 rate (67 TFLOP/s without the
// tensor cores): 2 d FMA operations per visible (query, key) pair for each
// product (K7 two, K9 three, K10 four, K11 five). K8 writes its plane
// (4 bytes an entry) under one product. The blocks stage each tile once
// and reuse it 64 times from shared memory, so they are bound by the FMA
// pipes and the shared-memory reads that feed them, not by device memory.
#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kB = 64;         // rows of a query tile, keys of a key tile (= kTile)
constexpr int kThreads = 256;  // 16 x 16
constexpr int kLdT = kB + 4;   // padded row of a 64 x 64 tile (P, dS)
static_assert(kB == kTile, "the tile tables are per 64 rows and keys");

template <int D>
struct Ld {
  static constexpr int kRow = D + 4;          // padded row of a 64 x D tile
  static constexpr int kTile = kB * kRow;     // floats of a 64 x D tile
  static constexpr int kCols = D / 16;        // columns of a thread in a 64 x D product
};

constexpr int kSmallTile = kB * kLdT;  // floats of a 64 x 64 tile

// Rows [r0, r0 + 64) of a (n, D) matrix with row stride `stride` (elements;
// the last dimension contiguous, rows 16-byte aligned) into dst [64][D + 4],
// times mul; rows past n are zeros. Each thread issues its loads before it
// stores them.
template <int D>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const float* __restrict__ src,
                                          int64_t stride, int r0, int n, float mul = 1.f) {
  constexpr int kChunks = D / 4;
  constexpr int kIters = kB * kChunks / kThreads;
  float4 buf[kIters];
#pragma unroll
  for (int u = 0; u < kIters; ++u) {
    const int c = threadIdx.x + u * kThreads;
    const int r = c / kChunks, col = (c % kChunks) * 4;
    buf[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n)
      buf[u] = *reinterpret_cast<const float4*>(src + static_cast<int64_t>(r0 + r) * stride + col);
  }
#pragma unroll
  for (int u = 0; u < kIters; ++u) {
    const int c = threadIdx.x + u * kThreads;
    const int r = c / kChunks, col = (c % kChunks) * 4;
    float4 x = buf[u];
    if (mul != 1.f) {
      x.x *= mul;
      x.y *= mul;
      x.z *= mul;
      x.w *= mul;
    }
    *reinterpret_cast<float4*>(dst + r * Ld<D>::kRow + col) = x;
  }
}

// acc[i][j] = sum over k < K of A[4 ty + i][k] * B[tx + 16 j][k], in order of k.
template <int K, int LDA, int LDB>
__device__ __forceinline__ void mma_nt(float (&acc)[4][4], const float* __restrict__ A,
                                       const float* __restrict__ B, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const float* a = A + 4 * ty * LDA;
  const float* b = B + tx * LDB;
#pragma unroll 1
  for (int k = 0; k < K; k += 4) {
    float4 av[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(a + i * LDA + k);
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // one B row at a time: fewer live registers
      const float4 bv = *reinterpret_cast<const float4*>(b + 16 * j * LDB + k);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][j] = fmaf(av[i].x, bv.x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv.y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv.z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv.w, acc[i][j]);
      }
    }
  }
}

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// acc[i][4 g + e] = sum over k < 64 of A(4 ty + i, k) * B[k][64 g + 4 tx + e],
// in order of k; A(m, k) is A[m][k] (kTransA false) or A[k][m] (true), with
// rows of kLdT floats; B rows of LDB floats.
template <int D, int LDB, bool kTransA>
__device__ __forceinline__ void mma_nn(float (&acc)[4][D / 16], const float* __restrict__ A,
                                       const float* __restrict__ B, int ty, int tx) {
  constexpr int G = D / 64;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
#pragma unroll 1
  for (int k = 0; k < kB; k += 4) {
    float4 av[4];  // kTransA false: av[i] = row 4 ty + i at k .. k + 3; true: av[kk] = k + kk
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = kTransA ? *reinterpret_cast<const float4*>(A + (k + i) * kLdT + 4 * ty)
                      : *reinterpret_cast<const float4*>(A + (4 * ty + i) * kLdT + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float4 bv[G];
#pragma unroll
      for (int g = 0; g < G; ++g)
        bv[g] = *reinterpret_cast<const float4*>(B + (k + kk) * LDB + 64 * g + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = kTransA ? comp(av[kk], i) : comp(av[i], kk);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          acc[i][4 * g + 0] = fmaf(a, bv[g].x, acc[i][4 * g + 0]);
          acc[i][4 * g + 1] = fmaf(a, bv[g].y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(a, bv[g].z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(a, bv[g].w, acc[i][4 * g + 3]);
        }
      }
    }
  }
}

// One row of a 64 x D tile held as mma_nn leaves it (x = acc[i]), stored
// to dst (the row's first element) as float4s.
template <int D>
__device__ __forceinline__ void store_row(float* dst, const float (&x)[D / 16], int tx) {
#pragma unroll
  for (int g = 0; g < D / 64; ++g)
    *reinterpret_cast<float4*>(dst + 64 * g + 4 * tx) =
        make_float4(x[4 * g], x[4 * g + 1], x[4 * g + 2], x[4 * g + 3]);
}

// The sum over the 16 lanes that hold one row of a score tile, and its max.
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Dropout keep bits of a thread's 16 entries of a score tile with rows as
// queries: bit 4 i + j keeps (row0 + i, k0 + tx + 16 j), row0 = q0 + 4 ty.
// The four lanes whose keys share a Philox call (keys 4 g .. 4 g + 3 of one
// row) each make the call of one of the four rows and trade the keep bits.
__device__ __forceinline__ uint32_t keep_bits_rows(const XfaExtras& ex, int ib, int ih, int row0,
                                                   int k0, int tx) {
  const int lane = threadIdx.x & 31;
  uint32_t keep = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint4 w = dropout_words(ex, ib, ih, row0 + (tx & 3), k0 + 16 * j + (tx & ~3));
    const uint32_t mine = (w.x >= ex.drop_thresh ? 1u : 0u) | (w.y >= ex.drop_thresh ? 2u : 0u) |
                          (w.z >= ex.drop_thresh ? 4u : 0u) | (w.w >= ex.drop_thresh ? 8u : 0u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t got = __shfl_sync(0xffffffffu, mine, (lane & ~3) | i);
      keep |= ((got >> (tx & 3)) & 1u) << (4 * i + j);
    }
  }
  return keep;
}

// The softcap and ALiBi on a thread's 16 scores (rows q0 + 4 ty + i, keys
// k0 + tx + 16 j) after the product, as K7 and K8 compute them (the slopes
// read where they are used: K7 keeps no registers for them).
__device__ __forceinline__ void score_options(float (&s)[4][4], const Mask& mask,
                                              const XfaExtras& ex, int ib, int ih, int h,
                                              float softcap, int q0, int k0, int ty, int tx) {
  const bool alibi = ex.alibi != nullptr || ex.row_slopes != nullptr;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float slope = alibi ? alibi_slope(ex, ib, ih, h, mask.sq, q0 + 4 * ty + i) : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float x = s[i][j];
      if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
      if (alibi) x -= slope * mask.dist(q0 + 4 * ty + i, k0 + tx + 16 * j);
      s[i][j] = x;
    }
  }
}

// What the forward kernels (K7, K8) read besides q, k, v.
struct FwdArgs {
  const float *q, *k, *v;
  float* o;                // K7: (b, h, sq, d) with strides o_s
  float* lse;              // K7: written, K8: read; (b, h, sq)
  float* probs;            // K8: (b, h, sq, sk) contiguous
  int64_t q_s[3], k_s[3], v_s[3], o_s[3];  // element strides (batch, head, row)
  const int32_t *kv_lens, *qseg, *kseg;
  int b, h, h_k, sq, sk, wl, wr, n_qt;
  float softcap, scale;
};

// ---- K7: the forward ------------------------------------------------------------

// Shared memory of a K7 block: Q (times the scale), K (then P), V.
template <int D>
struct FwdSmem {
  static constexpr int q = 0;
  static constexpr int k = Ld<D>::kTile;  // K, then P (64 x kLdT)
  static constexpr int v = 2 * Ld<D>::kTile;
  static constexpr int bytes = 3 * Ld<D>::kTile * 4;
  static_assert(kSmallTile <= Ld<D>::kTile, "P fits K's place");
};

// One block owns one (batch, q head, 64-row q tile), K7's blocks in K7's
// order (heaviest first), and walks the live key tiles: S = Q K^T, the
// online softmax (each row's max and sum over its 16 lanes), P into K's
// place, this tile's P V summed from zero and added to O after the
// correction. Two blocks an SM (99 KB of shared memory at d = 128).
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_f32_kernel(const FwdArgs p, const XfaExtras ex) {
  using L = FwdSmem<D>;
  constexpr int LD = Ld<D>::kRow, NC = Ld<D>::kCols;
  extern __shared__ __align__(16) float sm[];
  float* qs = sm + L::q;
  float* ks = sm + L::k;
  float* ps = sm + L::k;
  float* vs = sm + L::v;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  const int nbh = p.b * p.h;
  const int iq = p.n_qt - 1 - static_cast<int>(blockIdx.x) / nbh;
  const int ih = static_cast<int>(blockIdx.x) % nbh % p.h;
  const int ib = static_cast<int>(blockIdx.x) % nbh / p.h;
  const int ihk = ih / (p.h / p.h_k);
  const int q0 = iq * kB;
  // the mask is made again where it is used, so that its fields hold no
  // registers across the products (two blocks an SM leave 128 a thread)
  auto mask_of = [&]() {
    return make_mask(ib, p.sq, p.sk, p.wl, p.wr, p.kv_lens, p.qseg, p.kseg, ex);
  };
  int k_lo, k_hi;
  mask_of().key_range(q0, min(q0 + kB, p.sq), k_lo, k_hi);

  const float* qb = p.q + ib * p.q_s[0] + ih * p.q_s[1];
  const float* kb = p.k + ib * p.k_s[0] + ihk * p.k_s[1];
  const float* vb = p.v + ib * p.v_s[0] + ihk * p.v_s[1];
  load_tile<D>(qs, qb, p.q_s[2], q0, p.sq, p.scale);

  const bool drop = ex.drop_thresh != 0;
  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMFloor;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = (k_lo / kB) * kB; k0 < k_hi; k0 += kB) {
    if (!tiles_meet(ex, mask_of(), ib, q0, k0)) continue;
    __syncthreads();  // the last tile's P and V are read (and Q is stored)
    load_tile<D>(ks, kb, p.k_s[2], k0, p.sk);
    load_tile<D>(vs, vb, p.v_s[2], k0, p.sk);
    __syncthreads();
    float s[4][4];
    mma_nt<D, LD, LD>(s, qs, ks, ty, tx);
    const Mask mask = mask_of();
    score_options(s, mask, ex, ib, ih, p.h, p.softcap, q0, k0, ty, tx);
    if (!tile_interior<true>(mask, ex, ib, q0, k0)) {  // the mask on boundary tiles only
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (!mask.keep(q0 + 4 * ty + i, k0 + tx + 16 * j)) s[i][j] = kNegInf;
    }
    const uint32_t keep = drop ? keep_bits_rows(ex, ib, ih, q0 + 4 * ty, k0, tx) : 0xFFFFu;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mx = row_max16(fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3])));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);  // exactly 1 when the max holds
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * corr + row_sum16(sum);
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j)  // dropout: P leaves the sum whole, the product without
        if (!((keep >> (4 * i + j)) & 1u)) s[i][j] = 0.f;
    }
    __syncthreads();  // every warp is done with K before P takes its place
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(4 * ty + i) * kLdT + tx + 16 * j] = s[i][j];
    __syncthreads();
#pragma unroll
    for (int g = 0; g < D / 64; ++g) {  // 64 columns at a time: 16 registers of tile sum
      float t[4][4];
      mma_nn<64, LD, false>(t, ps, vs + 64 * g, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][4 * g + e] += t[i][e];
    }
  }

  // epilogue: O = acc / l (times 1 / (1 - p) with dropout), LSE = m + log l
  const size_t bh = static_cast<size_t>(ib) * p.h + ih;
  float* ob = p.o + ib * p.o_s[0] + ih * p.o_s[1];
  const float drop_scale = ex.drop_scale;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    if (qi >= p.sq) continue;
    const bool no_key = l[i] <= 0.f;
    const float inv = no_key ? 0.f : 1.f / l[i];
    float row[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) row[c] = no_key ? 0.f : (acc[i][c] * inv) * drop_scale;
    store_row<D>(ob + qi * p.o_s[2], row, tx);
    if (tx == 0) p.lse[bh * p.sq + qi] = no_key ? -INFINITY : m[i] + logf(l[i]);
  }
}

// ---- K8: the probability plane ------------------------------------------------------

template <int D>
struct ProbsSmem {
  static constexpr int q = 0;
  static constexpr int k = Ld<D>::kTile;
  static constexpr int bytes = 2 * Ld<D>::kTile * 4;
};

// One block owns one (batch, q head, 64-row q tile) and writes every key
// tile of its rows: S = Q K^T on live tiles, exp(S - LSE) where the mask
// keeps the entry and the row's LSE is finite, negated where the dropout
// dropped it; dead tiles (outside the key range, or the tile tables say no
// pair meets) get zeros without a product.
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_probs_f32_kernel(const FwdArgs p, const XfaExtras ex) {
  using L = ProbsSmem<D>;
  constexpr int LD = Ld<D>::kRow;
  extern __shared__ __align__(16) float sm[];
  float* qs = sm + L::q;
  float* ks = sm + L::k;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  const int nbh = p.b * p.h;
  const int iq = p.n_qt - 1 - static_cast<int>(blockIdx.x) / nbh;
  const int ih = static_cast<int>(blockIdx.x) % nbh % p.h;
  const int ib = static_cast<int>(blockIdx.x) % nbh / p.h;
  const int ihk = ih / (p.h / p.h_k);
  const int q0 = iq * kB;
  const Mask mask = make_mask(ib, p.sq, p.sk, p.wl, p.wr, nullptr, p.qseg, p.kseg, ex);
  int k_lo, k_hi;
  mask.key_range(q0, min(q0 + kB, p.sq), k_lo, k_hi);
  const int k_first = (k_lo / kB) * kB;

  const float* qb = p.q + ib * p.q_s[0] + ih * p.q_s[1];
  const float* kb = p.k + ib * p.k_s[0] + ihk * p.k_s[1];
  const size_t bh = static_cast<size_t>(ib) * p.h + ih;
  float* out = p.probs + bh * p.sq * p.sk;
  load_tile<D>(qs, qb, p.q_s[2], q0, p.sq, p.scale);

  const bool drop = ex.drop_thresh != 0;
  float lse[4];
  bool live[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    lse[i] = qi < p.sq ? p.lse[bh * p.sq + qi] : -INFINITY;
    live[i] = lse[i] > -3e38f;
  }

  for (int k0 = 0; k0 < p.sk; k0 += kB) {
    float s[4][4];
    const bool dead = k0 < k_first || k0 >= k_hi || !tiles_meet(ex, mask, ib, q0, k0);
    if (dead) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    } else {
      __syncthreads();  // the last tile's K is read (and Q is stored)
      load_tile<D>(ks, kb, p.k_s[2], k0, p.sk);
      __syncthreads();
      mma_nt<D, LD, LD>(s, qs, ks, ty, tx);
      score_options(s, mask, ex, ib, ih, p.h, p.softcap, q0, k0, ty, tx);
      const uint32_t keep = drop ? keep_bits_rows(ex, ib, ih, q0 + 4 * ty, k0, tx) : 0xFFFFu;
      const bool interior = tile_interior<true>(mask, ex, ib, q0, k0);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool vis =
              live[i] && (interior || mask.keep(q0 + 4 * ty + i, k0 + tx + 16 * j));
          const float x = vis ? expf(s[i][j] - lse[i]) : 0.f;
          s[i][j] = vis && !((keep >> (4 * i + j)) & 1u) ? -x : x;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * ty + i;
      if (qi >= p.sq) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        if (kj < p.sk) out[static_cast<size_t>(qi) * p.sk + kj] = s[i][j];
      }
    }
  }
}

// ---- K9, K10, K11: the backward -------------------------------------------------------

struct BwdArgs {
  const float *q, *k, *v, *dout, *lse, *delta;  // lse, delta: (b, h, sq)
  float *dq, *dk, *dv;                          // K11: dq is the f32 buffer dQ is added into
  int64_t st[7][3];  // element strides (batch, head, row) of q, k, v, dO, dq, dk, dv
  const int32_t *kv_lens, *qseg, *kseg;
  int b, h, h_k, sq, sk, wl, wr;
  float scale, softcap;
};
enum Operand { kQ, kK, kV, kDO, kDQ, kDK, kDV };

// Shared memory of a K9 block: Q, dO, K, and V (then dS).
template <int D>
struct DqSmem {
  static constexpr int q = 0, dout = Ld<D>::kTile, k = 2 * Ld<D>::kTile, v = 3 * Ld<D>::kTile;
  static constexpr int bytes = 4 * Ld<D>::kTile * 4;
};

// The backward's per-entry recompute of a thread's 16 entries, rows i and
// columns j of a score tile, from S (raw) and dP: P z (into s) and dS (into
// dp). qi(i, j), kj(i, j) give an entry's query and key, lse / delta /
// slope its row's values, keep(i, j) its dropout bit.
template <class QI, class KJ, class LSE, class KEEP>
__device__ __forceinline__ void recompute_tile(float (&s)[4][4], float (&dp)[4][4],
                                               const Mask& mask, bool interior, bool alibi,
                                               float scale, float softcap, float drop_scale,
                                               QI qi, KJ kj, LSE row, KEEP kept) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = qi(i, j), k = kj(i, j);
      float lse, delta, slope;
      row(i, j, lse, delta, slope);
      const bool keep = interior || mask.keep(q, k);
      const float bias = alibi ? slope * mask.dist(q, k) : 0.f;
      const float z = kept(i, j) ? drop_scale : 0.f;
      float p_dv, ds;
      recompute_p_ds(s[i][j], dp[i][j], lse, delta, keep, scale, softcap, bias, z, p_dv, ds);
      s[i][j] = p_dv;
      dp[i][j] = ds;
    }
}

// One block owns one (batch, q head, 64-row q tile), in K7's order, and
// walks the key tiles its rows see: S = Q K^T, dP = dO V^T, P and dS per
// entry, dS into V's place, this tile's dS K summed from zero and added to
// dQ. One block an SM (135 KB at d = 128). dQ sums in registers: K9 is
// bit-reproducible.
template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_f32_kernel(const BwdArgs p,
                                                                       const XfaExtras ex) {
  using L = DqSmem<D>;
  constexpr int LD = Ld<D>::kRow, NC = Ld<D>::kCols;
  extern __shared__ __align__(16) float sm[];
  float* qs = sm + L::q;
  float* dos = sm + L::dout;
  float* ks = sm + L::k;
  float* vs = sm + L::v;
  float* dss = sm + L::v;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  const int n_qt = (p.sq + kB - 1) / kB;
  const int nbh = p.b * p.h;
  const int iq = n_qt - 1 - static_cast<int>(blockIdx.x) / nbh;
  const int ih = static_cast<int>(blockIdx.x) % nbh % p.h;
  const int ib = static_cast<int>(blockIdx.x) % nbh / p.h;
  const int ihk = ih / (p.h / p.h_k);
  const int q0 = iq * kB;
  const Mask mask = make_mask(ib, p.sq, p.sk, p.wl, p.wr, p.kv_lens, p.qseg, p.kseg, ex);
  int k_lo, k_hi;
  mask.key_range(q0, min(q0 + kB, p.sq), k_lo, k_hi);

  load_tile<D>(qs, p.q + ib * p.st[kQ][0] + ih * p.st[kQ][1], p.st[kQ][2], q0, p.sq);
  load_tile<D>(dos, p.dout + ib * p.st[kDO][0] + ih * p.st[kDO][1], p.st[kDO][2], q0, p.sq);
  const float* kb = p.k + ib * p.st[kK][0] + ihk * p.st[kK][1];
  const float* vb = p.v + ib * p.st[kV][0] + ihk * p.st[kV][1];

  const bool alibi = ex.alibi != nullptr || ex.row_slopes != nullptr;
  const bool drop = ex.drop_thresh != 0;
  const size_t bh = static_cast<size_t>(ib) * p.h + ih;
  float lse[4], delta[4], slope[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    // rows past sq take LSE = +huge, so they give P = 0
    lse[i] = qi < p.sq ? safe_lse(p.lse[bh * p.sq + qi]) : 3.0e38f;
    delta[i] = qi < p.sq ? p.delta[bh * p.sq + qi] : 0.f;
    slope[i] = alibi_slope(ex, ib, ih, p.h, p.sq, qi);
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = (k_lo / kB) * kB; k0 < k_hi; k0 += kB) {
    if (!tiles_meet(ex, mask, ib, q0, k0)) continue;
    __syncthreads();  // the last tile's dS and K are read (and Q, dO are stored)
    load_tile<D>(ks, kb, p.st[kK][2], k0, p.sk);
    load_tile<D>(vs, vb, p.st[kV][2], k0, p.sk);
    __syncthreads();
    float s[4][4], dp[4][4];
    mma_nt<D, LD, LD>(s, qs, ks, ty, tx);
    mma_nt<D, LD, LD>(dp, dos, vs, ty, tx);
    const uint32_t keep = drop ? keep_bits_rows(ex, ib, ih, q0 + 4 * ty, k0, tx) : 0xFFFFu;
    recompute_tile(
        s, dp, mask, tile_interior<true>(mask, ex, ib, q0, k0), alibi, p.scale, p.softcap,
        ex.drop_scale, [&](int i, int) { return q0 + 4 * ty + i; },
        [&](int, int j) { return k0 + tx + 16 * j; },
        [&](int i, int, float& l_, float& d_, float& s_) {
          l_ = lse[i];
          d_ = delta[i];
          s_ = slope[i];
        },
        [&](int i, int j) { return ((keep >> (4 * i + j)) & 1u) != 0; });
    __syncthreads();  // every warp is done with V before dS takes its place
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dss[(4 * ty + i) * kLdT + tx + 16 * j] = dp[i][j];
    __syncthreads();
    float t[4][NC];
    mma_nn<D, LD, false>(t, dss, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] += t[i][c];
  }

  float* dqb = p.dq + ib * p.st[kDQ][0] + ih * p.st[kDQ][1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    if (qi < p.sq) store_row<D>(dqb + qi * p.st[kDQ][2], acc[i], tx);
  }
}

// Shared memory of a K10 / K11 block: K and V of its keys, the Q and dO
// tiles of the current pair, P^T and dS^T.
template <int D>
struct DkvSmem {
  static constexpr int k = 0, v = Ld<D>::kTile, q = 2 * Ld<D>::kTile,
                       dout = 3 * Ld<D>::kTile, pt = 4 * Ld<D>::kTile,
                       dst = 4 * Ld<D>::kTile + kSmallTile;
  static constexpr int bytes = (4 * Ld<D>::kTile + 2 * kSmallTile) * 4;
};

// One block owns one (batch, kv head, 64-key tile), in K10's order (key
// tile 0 first), and walks every (q head of the GQA group, 64-row q tile)
// pair that sees its keys: S^T = K Q^T and dP^T = V dO^T (rows are keys,
// columns queries), P^T and dS^T per entry, then this pair's P^T dO and
// dS^T Q, each summed from zero and added to dV and dK. K11 (kFused) also
// adds the pair's dQ = dS K (from dS^T) into the f32 buffer with atomics.
// dK and dV sum in registers in a fixed order: K10 is bit-reproducible.
// One block an SM (166 KB at d = 128).
template <int D, bool kFused>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkv_f32_kernel(const BwdArgs p,
                                                                        const XfaExtras ex) {
  using L = DkvSmem<D>;
  constexpr int LD = Ld<D>::kRow, NC = Ld<D>::kCols;
  extern __shared__ __align__(16) float sm[];
  float* ks = sm + L::k;
  float* vs = sm + L::v;
  float* qs = sm + L::q;
  float* dos = sm + L::dout;
  float* pts = sm + L::pt;
  float* dsts = sm + L::dst;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  const int nbh = p.b * p.h_k;
  const int ik = static_cast<int>(blockIdx.x) / nbh;
  const int ihk = static_cast<int>(blockIdx.x) % nbh % p.h_k;
  const int ib = static_cast<int>(blockIdx.x) % nbh / p.h_k;
  const int group = p.h / p.h_k;
  const int k0 = ik * kB;
  const Mask mask = make_mask(ib, p.sq, p.sk, p.wl, p.wr, p.kv_lens, p.qseg, p.kseg, ex);
  int q_lo, q_hi;
  mask.query_range(k0, k0 + kB, q_lo, q_hi);

  load_tile<D>(ks, p.k + ib * p.st[kK][0] + ihk * p.st[kK][1], p.st[kK][2], k0, p.sk);
  load_tile<D>(vs, p.v + ib * p.st[kV][0] + ihk * p.st[kV][1], p.st[kV][2], k0, p.sk);

  const bool alibi = ex.alibi != nullptr || ex.row_slopes != nullptr;
  const bool drop = ex.drop_thresh != 0;
  float dk[4][NC], dv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int ih = ihk * group + g;
    const size_t bh = static_cast<size_t>(ib) * p.h + ih;
    const float* qb = p.q + ib * p.st[kQ][0] + ih * p.st[kQ][1];
    const float* dob = p.dout + ib * p.st[kDO][0] + ih * p.st[kDO][1];
    for (int q0 = (q_lo / kB) * kB; q0 < q_hi; q0 += kB) {
      if (!tiles_meet(ex, mask, ib, q0, k0)) continue;
      __syncthreads();  // the last pair's tiles are read (and K, V are stored)
      load_tile<D>(qs, qb, p.st[kQ][2], q0, p.sq);
      load_tile<D>(dos, dob, p.st[kDO][2], q0, p.sq);
      __syncthreads();
      float s[4][4], dp[4][4];  // rows: keys k0 + 4 ty + i; columns: queries q0 + tx + 16 j
      mma_nt<D, LD, LD>(s, ks, qs, ty, tx);
      mma_nt<D, LD, LD>(dp, vs, dos, ty, tx);
      float lse[4], delta[4], slope[4];
      uint32_t keep = 0xFFFFu;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = q0 + tx + 16 * j;
        lse[j] = qi < p.sq ? safe_lse(p.lse[bh * p.sq + qi]) : 3.0e38f;
        delta[j] = qi < p.sq ? p.delta[bh * p.sq + qi] : 0.f;
        slope[j] = alibi_slope(ex, ib, ih, p.h, p.sq, qi);
        if (drop) {  // one Philox call gives this query's four keys 4 ty .. 4 ty + 3
          const uint4 w = dropout_words(ex, ib, ih, qi, k0 + 4 * ty);
          const uint32_t bits = (w.x >= ex.drop_thresh ? 1u : 0u) |
                                (w.y >= ex.drop_thresh ? 2u : 0u) |
                                (w.z >= ex.drop_thresh ? 4u : 0u) |
                                (w.w >= ex.drop_thresh ? 8u : 0u);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (!((bits >> i) & 1u)) keep &= ~(1u << (4 * i + j));
        }
      }
      recompute_tile(
          s, dp, mask, tile_interior<true>(mask, ex, ib, q0, k0), alibi, p.scale, p.softcap,
          ex.drop_scale, [&](int, int j) { return q0 + tx + 16 * j; },
          [&](int i, int) { return k0 + 4 * ty + i; },
          [&](int, int j, float& l_, float& d_, float& s_) {
            l_ = lse[j];
            d_ = delta[j];
            s_ = slope[j];
          },
          [&](int i, int j) { return ((keep >> (4 * i + j)) & 1u) != 0; });
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          pts[(4 * ty + i) * kLdT + tx + 16 * j] = s[i][j];
          dsts[(4 * ty + i) * kLdT + tx + 16 * j] = dp[i][j];
        }
      __syncthreads();
      float t[4][NC];
      mma_nn<D, LD, false>(t, pts, dos, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) dv[i][c] += t[i][c];
      mma_nn<D, LD, false>(t, dsts, qs, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) dk[i][c] += t[i][c];
      if constexpr (kFused) {  // dQ of the pair's rows = dS K, dS^T read transposed
        mma_nn<D, LD, true>(t, dsts, ks, ty, tx);
        float* dqb = p.dq + ib * p.st[kDQ][0] + ih * p.st[kDQ][1];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = q0 + 4 * ty + i;
          if (qi >= p.sq) continue;
          float* row = dqb + qi * p.st[kDQ][2];
#pragma unroll
          for (int gi = 0; gi < D / 64; ++gi)
#pragma unroll
            for (int e = 0; e < 4; ++e) atomicAdd(row + 64 * gi + 4 * tx + e, t[i][4 * gi + e]);
        }
      }
    }
  }

  float* dkb = p.dk + ib * p.st[kDK][0] + ihk * p.st[kDK][1];
  float* dvb = p.dv + ib * p.st[kDV][0] + ihk * p.st[kDV][1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + 4 * ty + i;
    if (kj >= p.sk) continue;
    store_row<D>(dkb + kj * p.st[kDK][2], dk[i], tx);
    store_row<D>(dvb + kj * p.st[kDV][2], dv[i], tx);
  }
}

template <class Kernel>
cudaError_t set_smem(Kernel* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
cudaError_t launch_fwd(const FwdArgs& a, const XfaExtras& ex, bool probs, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>(a.n_qt) * a.h * a.b;
  if (probs) {
    auto* kernel = &flash_probs_f32_kernel<D>;
    cudaError_t err = set_smem(kernel, ProbsSmem<D>::bytes);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, ProbsSmem<D>::bytes, stream>>>(a, ex);
  } else {
    auto* kernel = &flash_fwd_f32_kernel<D>;
    cudaError_t err = set_smem(kernel, FwdSmem<D>::bytes);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, FwdSmem<D>::bytes, stream>>>(a, ex);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const BwdArgs& a, const XfaExtras& ex, cudaStream_t stream) {
  auto* kernel = &flash_bwd_dq_f32_kernel<D>;
  cudaError_t err = set_smem(kernel, DqSmem<D>::bytes);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((a.sq + kB - 1) / kB) * a.h * a.b;
  kernel<<<grid, kThreads, DqSmem<D>::bytes, stream>>>(a, ex);
  return cudaGetLastError();
}

template <int D, bool kFused>
cudaError_t launch_dkv(const BwdArgs& a, const XfaExtras& ex, cudaStream_t stream) {
  auto* kernel = &flash_bwd_dkv_f32_kernel<D, kFused>;
  cudaError_t err = set_smem(kernel, DkvSmem<D>::bytes);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((a.sk + kB - 1) / kB) * a.h_k * a.b;
  kernel<<<grid, kThreads, DkvSmem<D>::bytes, stream>>>(a, ex);
  return cudaGetLastError();
}

bool valid(int dtype, int d, int h, int h_k, const void* q_seg, const void* kv_seg,
           const XfaExtras* ex, const int64_t* strides) {
  return dtype == XFA_F32 && (d == 64 || d == 128) && h_k > 0 && h % h_k == 0 &&
         (q_seg == nullptr) == (kv_seg == nullptr) && ex != nullptr && strides != nullptr &&
         (ex->qpos == nullptr) == (ex->kpos == nullptr) &&
         (ex->qtiles == nullptr) == (ex->ktiles == nullptr);
}

void copy_strides(int64_t (&dst)[3], const int64_t* src) {
  for (int j = 0; j < 3; ++j) dst[j] = src[j];
}

BwdArgs make_bwd_args(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, void* dk, void* dv,
                      const void* kv_lens, const void* q_seg, const void* kv_seg, int b, int h,
                      int h_k, int sq, int sk, int wl, int wr, float scale, float softcap,
                      const int64_t* strides) {
  BwdArgs a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.dout = static_cast<const float*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  for (int o = 0; o < 7; ++o) copy_strides(a.st[o], strides + 3 * o);
  a.kv_lens = static_cast<const int32_t*>(kv_lens);
  a.qseg = static_cast<const int32_t*>(q_seg);
  a.kseg = static_cast<const int32_t*>(kv_seg);
  a.b = b;
  a.h = h;
  a.h_k = h_k;
  a.sq = sq;
  a.sk = sk;
  a.wl = wl;
  a.wr = wr;
  a.scale = scale;
  a.softcap = softcap;
  return a;
}

}  // namespace

// The entry points take the arguments of their 16-bit counterparts
// (xfa_flash_fwd, xfa_flash_probs, xfa_flash_bwd_dq, xfa_flash_bwd_dkv) with
// dtype XFA_F32: f32 tensors, d 64 or 128, each with its last dimension
// contiguous and its (batch, head, row) element strides in `strides`
// (multiples of 4, bases 16-byte aligned: float4 loads and stores), q not
// pre-scaled; lse and delta (b, h, sq) f32 contiguous; kv_lens (b,), q_seg
// (b, sq), kv_seg (b, sk) int32 or null; wl / wr the window (< 0
// unbounded); extras (ALiBi, positions, tile tables, dropout;
// flash_common.cuh) in host memory.

// K7: strides q, k, v, o; writes o (b, h, sq, d) and lse (b, h, sq).
extern "C" int xfa_flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                 void* lse, const void* kv_lens, const void* q_seg,
                                 const void* kv_seg, int dtype, int b, int h, int h_k, int sq,
                                 int sk, int d, int wl, int wr, float softcap, float scale,
                                 const int64_t* strides, const flash::XfaExtras* extras,
                                 void* stream) {
  if (!valid(dtype, d, h, h_k, q_seg, kv_seg, extras, strides)) return cudaErrorInvalidValue;
  if (b * h * sq == 0) return cudaSuccess;
  FwdArgs a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<float*>(o);
  a.lse = static_cast<float*>(lse);
  copy_strides(a.q_s, strides);
  copy_strides(a.k_s, strides + 3);
  copy_strides(a.v_s, strides + 6);
  copy_strides(a.o_s, strides + 9);
  a.kv_lens = static_cast<const int32_t*>(kv_lens);
  a.qseg = static_cast<const int32_t*>(q_seg);
  a.kseg = static_cast<const int32_t*>(kv_seg);
  a.b = b;
  a.h = h;
  a.h_k = h_k;
  a.sq = sq;
  a.sk = sk;
  a.wl = wl;
  a.wr = wr;
  a.n_qt = (sq + kB - 1) / kB;
  a.softcap = softcap;
  a.scale = scale;
  auto st = static_cast<cudaStream_t>(stream);
  return d == 128 ? launch_fwd<128>(a, *extras, false, st) : launch_fwd<64>(a, *extras, false, st);
}

// K8: strides q, k; reads lse (b, h, sq); writes out (b, h, sq, sk) contiguous.
extern "C" int xfa_flash_probs_f32(const void* q, const void* k, const void* lse, void* out,
                                   const void* q_seg, const void* kv_seg, int dtype, int b,
                                   int h, int h_k, int sq, int sk, int d, int wl, int wr,
                                   float softcap, float scale, const int64_t* strides,
                                   const flash::XfaExtras* extras, void* stream) {
  if (!valid(dtype, d, h, h_k, q_seg, kv_seg, extras, strides)) return cudaErrorInvalidValue;
  if (b == 0 || h == 0 || sq == 0 || sk == 0) return cudaSuccess;
  FwdArgs a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.lse = static_cast<float*>(const_cast<void*>(lse));
  a.probs = static_cast<float*>(out);
  copy_strides(a.q_s, strides);
  copy_strides(a.k_s, strides + 3);
  a.qseg = static_cast<const int32_t*>(q_seg);
  a.kseg = static_cast<const int32_t*>(kv_seg);
  a.b = b;
  a.h = h;
  a.h_k = h_k;
  a.sq = sq;
  a.sk = sk;
  a.wl = wl;
  a.wr = wr;
  a.n_qt = (sq + kB - 1) / kB;
  a.softcap = softcap;
  a.scale = scale;
  auto st = static_cast<cudaStream_t>(stream);
  return d == 128 ? launch_fwd<128>(a, *extras, true, st) : launch_fwd<64>(a, *extras, true, st);
}

// K9: strides q, k, v, dout, dq, dk, dv (dk, dv unused); writes dq (b, h, sq, d).
extern "C" int xfa_flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dq, const void* kv_lens, const void* q_seg,
                                    const void* kv_seg, int dtype, int b, int h, int h_k, int sq,
                                    int sk, int d, int wl, int wr, float scale, float softcap,
                                    const flash::XfaExtras* extras, const int64_t* strides,
                                    void* stream) {
  if (!valid(dtype, d, h, h_k, q_seg, kv_seg, extras, strides)) return cudaErrorInvalidValue;
  if (b * h * sq == 0) return cudaSuccess;
  const BwdArgs a = make_bwd_args(q, k, v, dout, lse, delta, dq, nullptr, nullptr, kv_lens,
                                  q_seg, kv_seg, b, h, h_k, sq, sk, wl, wr, scale, softcap,
                                  strides);
  auto st = static_cast<cudaStream_t>(stream);
  return d == 128 ? launch_dq<128>(a, *extras, st) : launch_dq<64>(a, *extras, st);
}

// K10 (fused = 0): writes dk, dv (b, h_k, sk, d). K11 (fused = 1): also adds
// dQ into dq_acc (b, h, sq, d) f32 (strides at the dq slot), which the
// caller zeroes before.
extern "C" int xfa_flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dk, void* dv, void* dq_acc, const void* kv_lens,
                                     const void* q_seg, const void* kv_seg, int dtype, int b,
                                     int h, int h_k, int sq, int sk, int d, int wl, int wr,
                                     float scale, float softcap, const flash::XfaExtras* extras,
                                     int fused, const int64_t* strides, void* stream) {
  if (!valid(dtype, d, h, h_k, q_seg, kv_seg, extras, strides)) return cudaErrorInvalidValue;
  if (fused && dq_acc == nullptr) return cudaErrorInvalidValue;
  if (b * h_k * sk == 0) return cudaSuccess;
  const BwdArgs a = make_bwd_args(q, k, v, dout, lse, delta, dq_acc, dk, dv, kv_lens, q_seg,
                                  kv_seg, b, h, h_k, sq, sk, wl, wr, scale, softcap, strides);
  auto st = static_cast<cudaStream_t>(stream);
  if (fused)
    return d == 128 ? launch_dkv<128, true>(a, *extras, st) : launch_dkv<64, true>(a, *extras, st);
  return d == 128 ? launch_dkv<128, false>(a, *extras, st) : launch_dkv<64, false>(a, *extras, st);
}
