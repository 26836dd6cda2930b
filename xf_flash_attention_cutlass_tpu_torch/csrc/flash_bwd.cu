// Dense flash-attention backward: K9 (dQ pass), K10 (dK/dV pass) and K11 (one
// pass, dQ by atomics), sharing one recompute of P and dS.
//
// Replaces the TPU kernels of xf_flash_attention_cutlass_tpu/ops/flash_bwd.py:
// `_dq_kernel` (:228), `_dkv_kernel` (:284) and `_bwd_fused_kernel` (:156).
// Every kernel recomputes, for its (query, key) tiles,
//   S = Q K^T * scale (tanh softcap), P = exp(S - LSE) (masked entries 0),
//   dP = dO V^T, dS = P (dP - Delta) (softcap derivative) * scale,
// with Delta = rowsum(dO * O) computed by the wrapper in plain torch, as the
// JAX package leaves it to XLA. P is rounded to dO's dtype for dV, dS to Q's
// for dK and to K's for dQ, as the plain version does. Then
//   K9:  one block per (batch, q head, 64-row q tile), a loop over the key
//        tiles its rows see; dQ += dS K sums in f32 registers (no atomics,
//        so K9 is bit-reproducible).
//   K10: one block per (batch, kv head, 64-key tile), a loop over the GQA
//        group's q heads and the 64-row q tiles that see its keys;
//        dV += P^T dO and dK += dS^T Q sum in f32 registers, so the GQA head
//        sum happens in the kernel (the TPU kernel's :14-17) with no pass after.
//   K11: K10's block and loop, plus dQ: the tile's dS K is added to an f32 dQ
//        buffer with atomics, whose order changes from run to run, so dQ of
//        K11 is not bit-reproducible; it agrees with K9 to f32 rounding.
//
// K9 on Hopper (hopper.cuh), on K7's skeleton (flash_fwd.cu):
// - A producer warpgroup (one lane; it gives its registers to the consumer,
//   setmaxnreg) TMA-loads the block's Q and dO tiles once, then the K and
//   V tiles of every live key tile into a ring of kStagesDq stages with full
//   and empty mbarriers (128-byte swizzle; the tensor maps take the caller's
//   strides, and TMA zero-fills rows past sq and sk; rows past sq take
//   LSE = +huge, so they give P = 0).
// - One consumer warpgroup owns the 64 query rows, with their LSE, Delta and
//   ALiBi slope in registers. Per key tile: S = Q K^T and dP = dO V^T by
//   wgmma (M = 64 queries, N = 64 keys, both operands K-major), P and dS per
//   entry in the accumulator layout (rows are queries, as in K7, so the
//   mask, ALiBi distance and dropout apply with row = first row + 16 warp +
//   lane / 4), then dQ += dS K by wgmma with dS repacked from the
//   accumulators as the A registers and K read as an MN-major B operand
//   straight from the ring stage: K is never transposed by a copy. The
//   per-entry mask runs on boundary tiles only; in the options'
//   instantiation from a rolled loop, and lanes pair up on each Philox call
//   (dropout_bits_q). Two blocks fit on an SM, so one block's recompute
//   overlaps the other's products.
// - Blocks run heaviest first: the last q tiles of every (batch, head)
//   launch first, K7's order (ops/flash_fwd.py fwd_block_order).
//
// K10 and K11 on Hopper (hopper.cuh):
// - The K and V tiles of the block's 64 keys are TMA-loaded once and stay in
//   shared memory (128-byte swizzle). A producer warpgroup streams, for each
//   live (q head, q tile) pair, the Q and dO tiles by TMA into a ring of
//   kStagesBwd stages with full and empty mbarriers (one lane), and the
//   tile's LSE, Delta, ALiBi slopes and positions into the stage (a second
//   warp). It
//   gives its registers to the consumers (setmaxnreg). The tensor maps take
//   the caller's strides, so q, k, v and dO may be (b, s, h, d) views; TMA
//   zero-fills rows past sq and sk, and rows past sq take LSE = +huge, so
//   they give P = 0.
// - Two consumer warpgroups on the same 64 keys take every other pair of
//   the block's list, each with its own dK and dV accumulators. Per pair a
//   warpgroup runs S^T = K Q^T and dP^T = V dO^T by wgmma (M = 64 keys, N = 64
//   queries, both operands K-major in shared memory), recomputes P^T and dS^T
//   in the accumulator layout (the mma.sync C layout in each warp's 16 keys,
//   so flash_common.cuh's mask, ALiBi distance and dropout apply per entry
//   with key = first key + 16 warp + lane / 4 and query = column), then
//   dV += P^T dO and dK += dS^T Q by wgmma with P^T and dS^T repacked from the
//   accumulators as the A registers and dO and Q read as MN-major B operands
//   straight from the ring: nothing is transposed by a copy. The per-entry
//   mask runs on boundary pairs only (the diagonal, window edges, the kv_len
//   edge, segment or tile-table boundaries).
// - K11: the warpgroup stores dS^T, rounded to K's dtype, into shared memory
//   as it sits in the accumulators (keys as rows), and the 64 x D dQ tile =
//   dS K is wgmma with both operands MN-major (ss_tt), 64 columns at a time;
//   each part is added to the f32 buffer with float2 atomics.
// - The options' instantiation keeps the registers for the accumulators: the
//   mask and dropout bits of a thread's 32 entries come from rolled loops,
//   and four lanes share each Philox call (dropout_bits_t).
// - The warpgroups' dK and dV are summed through shared memory in the
//   epilogue, one f32 addition each, so K10 is bit-reproducible.
// - Blocks run heaviest first: key tile 0 of every (batch, kv head) launches
//   first, since under a causal mask the first key tiles see the most rows
//   (ops/flash_bwd.py bwd_block_order).
//
// ALiBi (per head or per row), explicit positions with their tile tables and
// dropout live in the kExtra instantiations only, as in K7: S loses the bias
// slope * |qpos - kpos| after the softcap, and an entry the dropout dropped
// (flash_common.cuh's Philox, keyed by batch, q head, row and key, so it
// replays the forward's mask) has dV's P and dS's dP zeroed, the kept ones
// scaled by 1 / (1 - p). K10 and K11 key each group member by its own q head.
//
// Bound on an H100: operations (three 64 x 64 x d products per live tile
// pair in K9, four in K10, five in K11, against two 64 x d tiles read a pair).
#include <type_traits>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;

constexpr int kBQ = 64;  // query rows per tile (K9 block, K10/K11 loop)
constexpr int kBK = 64;  // keys per tile (K9 loop, K10/K11 block)
static_assert(kBQ == kTile && kBK == kTile, "the tile tables are per 64 rows and keys");

// element strides (batch, head, row) of the tensors, in this order in the
// entry points' `strides` argument
enum Operand { kQ, kK, kV, kDO, kDQ, kDK, kDV, kOperands };

struct BwdArgs {
  const void *q, *k, *v, *dout, *lse, *delta;  // lse, delta: (b, h, sq) f32
  void* dq;                                    // (b, h, sq, d) in the input dtype
  const int32_t *kv_lens, *qseg, *kseg;
  int64_t st[kOperands][3];
  int b, h, h_k, sq, sk, wl, wr;
  float scale, softcap;
  XfaExtras ex;
};

using namespace hopper;

constexpr float kLog2e = 1.4426950408889634f;

// What the kernels read besides the tensor maps (q, k, v, dO).
struct BwdParams {
  const float* lse;    // (b, h, sq)
  const float* delta;  // (b, h, sq)
  void* dq;            // K9: dq in T; K11: the f32 buffer dQ is added into
  void* dk;
  void* dv;
  int64_t dq_s[3], dk_s[3], dv_s[3];  // element strides (batch, head, row)
  const int32_t* kv_lens;
  const int32_t* qseg;
  const int32_t* kseg;
  int b, h, h_k, sq, sk, wl, wr;
  float scale, softcap;
};

// rows krow, krow + 8 of a 64 x D accumulator (wgmma layout) as T pairs
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* base, int64_t row_stride, const float (&x)[D / 2],
                                           int krow, int n_rows, int col) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = krow + 8 * r;
    if (kj >= n_rows) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(base + kj * row_stride + n * 8 + col) =
          Mma<T>::pack(x[4 * n + 2 * r], x[4 * n + 2 * r + 1]);
  }
}

// ---- K9: dQ on Hopper ---------------------------------------------------------

constexpr int kStagesDq = 2;          // K/V ring depth
constexpr int kDqThreads = 128 + 128;  // the consumer warpgroup, then the producer warpgroup
// Two blocks an SM. ptxas budgets registers by warpgroup: with a lone
// producer warp it left the consumer 168 registers and d = 128 spilled, so
// the producer warpgroup hands its registers to the consumer (setmaxnreg).
constexpr int kDqProducerRegs = 40, kDqConsumerRegs = 216;
static_assert(2 * 128 * (kDqProducerRegs + kDqConsumerRegs) <= 65536, "register file");

// Shared memory of a K9 block, from a 1024-byte aligned base: the Q and the
// dO tile (D / 64 sub-tiles of 64 rows x 64 columns each), the ring of (K
// tile, V tile) stages (the same shape), then the barriers.
template <int D>
struct DqLayout {
  static constexpr int kSub = D / 64;
  static constexpr int kTileBytes = 64 * D * 2;
  static constexpr int kRingOffset = 2 * kTileBytes;
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kBarOffset = kRingOffset + kStagesDq * kStageBytes;
  static constexpr int kBytes = kBarOffset + 8 * (1 + 2 * kStagesDq) + 1024;  // + alignment
  static_assert(2 * kBytes <= 232448, "two blocks an SM");
};

// Dropout bits of a thread's 32 entries in the accumulator layout (bit i:
// entry i, query row0 + 8 ((i >> 1) & 1), key k0 + 8 (i >> 2) + col + (i & 1),
// was dropped). Lanes lane and lane ^ 1 need the same 16 Philox calls (their
// keys share each group of four), so each makes the 8 of one of the two rows
// and they trade the packed drop bits.
__device__ __forceinline__ uint32_t dropout_bits_q(const XfaExtras& ex, int ib, int ih, int row0,
                                                   int k0, int col, int lane) {
  const int mine = lane & 1;  // this lane's calls are row row0 + 8 mine's
  uint32_t made = 0;          // bit 4 j + w: word w of the call of key group j dropped
#pragma unroll 1
  for (int j = 0; j < kBK / 8; ++j) {
    const uint4 w = dropout_words(ex, ib, ih, row0 + 8 * mine, k0 + 8 * j + (col & 4));
    made |= ((w.x >= ex.drop_thresh ? 0u : 1u) | (w.y >= ex.drop_thresh ? 0u : 2u) |
             (w.z >= ex.drop_thresh ? 0u : 4u) | (w.w >= ex.drop_thresh ? 0u : 8u))
            << (4 * j);
  }
  const uint32_t other = __shfl_xor_sync(0xffffffffu, made, 1);
  uint32_t dropped = 0;
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) {
    const uint32_t src = ((i >> 1) & 1) == mine ? made : other;
    dropped |= ((src >> (4 * (i >> 2) + (col & 2) + (i & 1))) & 1u) << i;
  }
  return dropped;
}

template <typename T, int D, bool kExtra>
__global__ void __launch_bounds__(kDqThreads, 2)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do, const BwdParams p,
                        const XfaExtras ex) {
  using L = DqLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStagesDq;
  unsigned char* q_tile = smem;
  unsigned char* do_tile = smem + L::kTileBytes;
  auto k_tile = [&](int st) { return smem + L::kRingOffset + st * L::kStageBytes; };
  auto v_tile = [&](int st) { return k_tile(st) + L::kTileBytes; };

  // heaviest first: the last q tiles of every (batch, head) launch first
  const int nbh = p.b * p.h;
  const int n_qt = (p.sq + kBQ - 1) / kBQ;
  const int iq = n_qt - 1 - static_cast<int>(blockIdx.x) / nbh;
  const int ih = static_cast<int>(blockIdx.x) % nbh % p.h;
  const int ib = static_cast<int>(blockIdx.x) % nbh / p.h;
  const int ihk = ih / (p.h / p.h_k);
  const int q0 = iq * kBQ;
  Mask mask = make_mask(ib, p.sq, p.sk, p.wl, p.wr, p.kv_lens, p.qseg, p.kseg, ex);
  if constexpr (!kExtra) mask.qpos = mask.kpos = nullptr;

  // the key tiles the rows can see; with tile tables, those whose positions
  // and segments can meet the rows', numbered alike by producer and consumers
  int k_lo, k_hi;
  mask.key_range(q0, min(q0 + kBQ, p.sq), k_lo, k_hi);
  const int k_first = (k_lo / kBK) * kBK;
  auto needs = [&](int k0) {
    if constexpr (kExtra) return tiles_meet(ex, mask, ib, q0, k0);
    return true;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStagesDq; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 1);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // the producer warpgroup; one lane issues
    setmaxnreg_dec<kDqProducerRegs>();
    if (threadIdx.x == 128) {
      mbar_arrive_expect_tx(q_full, 2 * L::kTileBytes);
#pragma unroll
      for (int s = 0; s < L::kSub; ++s) {
        tma_load_4d(q_tile + s * kBQ * 128, &tm_q, q_full, s * 64, q0, ih, ib);
        tma_load_4d(do_tile + s * kBQ * 128, &tm_do, q_full, s * 64, q0, ih, ib);
      }
      int it = 0;
      for (int k0 = k_first; k0 < k_hi; k0 += kBK) {
        if (!needs(k0)) continue;
        const int st = it % kStagesDq;
        const uint32_t phase = (it / kStagesDq) & 1;
        ++it;
        mbar_wait(&empty[st], phase ^ 1);
        mbar_arrive_expect_tx(&full[st], L::kStageBytes);
#pragma unroll
        for (int s = 0; s < L::kSub; ++s) {
          tma_load_4d(k_tile(st) + s * kBK * 128, &tm_k, &full[st], s * 64, k0, ihk, ib);
          tma_load_4d(v_tile(st) + s * kBK * 128, &tm_v, &full[st], s * 64, k0, ihk, ib);
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroup: rows row, row + 8 of each warp's 16 ----
  setmaxnreg_inc<kDqConsumerRegs>();
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int row = q0 + warp * 16 + (lane >> 2);
  const int col = (lane & 3) * 2;  // its key columns in an 8-column group
  const size_t bh = static_cast<size_t>(ib) * p.h + ih;
  const bool dropout = kExtra && ex.drop_thresh != 0;
  const float drop_scale = kExtra ? ex.drop_scale : 1.f;
  const bool general = kExtra || p.softcap > 0.f;  // else no softcap, ALiBi or dropout
  const bool alibi = kExtra && (ex.alibi != nullptr || ex.row_slopes != nullptr);
  const float scale_log2 = p.scale * kLog2e;
  // per row: LSE (rows past sq: +huge, so P = 0), Delta, ALiBi slope, position
  float lse_r[2], lse2[2], delta_r[2], slope[2] = {0.f, 0.f}, qpos_f[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row + 8 * r;
    const bool live = qi < p.sq;
    lse_r[r] = live ? safe_lse(p.lse[bh * p.sq + qi]) : 3.0e38f;
    lse2[r] = lse_r[r] * kLog2e;
    delta_r[r] = live ? p.delta[bh * p.sq + qi] : 0.f;
    if constexpr (kExtra) {
      slope[r] = alibi_slope(ex, ib, ih, p.h, p.sq, qi);
      qpos_f[r] = static_cast<float>(mask.qp(qi));  // as Mask::dist reads it
    }
  }

  float acc[D / 2];  // dQ (64 rows x D): 8-column group n holds [4n .. 4n+3]
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[kBK / 2], dp[kBK / 2];  // S then P, dP then dS: (64 rows x 64 keys)
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) s[i] = dp[i] = 0.f;

  mbar_wait(q_full, 0);
  int it = 0;
  for (int k0 = k_first; k0 < k_hi; k0 += kBK) {
    if (!needs(k0)) continue;
    const int st = it % kStagesDq;
    const uint32_t phase = (it / kStagesDq) & 1;
    ++it;
    mbar_wait(&full[st], phase);
    const unsigned char* kt = k_tile(st);
    const unsigned char* vt = v_tile(st);

    // S = Q K^T and dP = dO V^T, both operands K-major
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk / 4) * 64 * 128 + (kk % 4) * 32;
      Wgmma<T, kBK>::ss(s, desc_sw128(q_tile + off, 16, 1024), desc_sw128(kt + off, 16, 1024),
                        kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk / 4) * 64 * 128 + (kk % 4) * 32;
      Wgmma<T, kBK>::ss(dp, desc_sw128(do_tile + off, 16, 1024), desc_sw128(vt + off, 16, 1024),
                        kk > 0);
    }
    wgmma_commit();

    // P and dS per entry: element i is query row + 8 ((i >> 1) & 1), key
    // k0 + 8 (i >> 2) + col + (i & 1); the mask on boundary tiles only
    const bool inner = tile_interior<kExtra>(mask, ex, ib, q0, k0);
    if (!general) {
      wgmma_wait<1>();  // S is ready; dP may still run
      fence_regs(s);
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const int r = (i >> 1) & 1;
        float pv = exp2f(fmaf(s[i], scale_log2, -lse2[r]));
        if (!inner && !mask.keep(row + 8 * r, k0 + 8 * (i >> 2) + col + (i & 1))) pv = 0.f;
        s[i] = pv;
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) dp[i] = s[i] * (dp[i] - delta_r[(i >> 1) & 1]) * p.scale;
    } else {
      // flash_common.cuh's recompute_p_ds in two halves around the dP
      // product: bit i says entry i is masked, and dropped (rolled loops, to
      // keep the registers for the accumulators; made while the products
      // run); then from S alone P times the softcap's derivative and the
      // scale; then dS = that (dP z - Delta)
      uint32_t masked = 0, dropped = 0;
      if (!inner) {
#pragma unroll 1
        for (int i = 0; i < kBK / 2; ++i)
          if (!mask.keep(row + 8 * ((i >> 1) & 1), k0 + 8 * (i >> 2) + col + (i & 1)))
            masked |= 1u << i;
      }
      if (dropout) dropped = dropout_bits_q(ex, ib, ih, row, k0, col, lane);
      wgmma_wait<1>();
      fence_regs(s);
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const int r = (i >> 1) & 1;
        float x = s[i] * p.scale, g = p.scale;
        if (p.softcap > 0.f) {
          const float th = tanhf(x / p.softcap);
          x = th * p.softcap;
          g *= 1.f - th * th;
        }
        if (alibi) {
          const float kpos = static_cast<float>(mask.kp(k0 + 8 * (i >> 2) + col + (i & 1)));
          x -= slope[r] * fabsf(qpos_f[r] - kpos);
        }
        s[i] = (masked >> i) & 1 ? 0.f : exp2f((x - lse_r[r]) * kLog2e) * g;
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const float z = (dropped >> i) & 1 ? 0.f : drop_scale;
        dp[i] = s[i] * (dp[i] * z - delta_r[(i >> 1) & 1]);
      }
    }

    // dQ += dS K: dS rounded to K's dtype as the A registers, K read
    // MN-major from the stage (its rows are the product's k index)
    uint32_t sa[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int w = 0; w < 4; ++w)
        sa[kk][w] = Mma<T>::pack(dp[8 * kk + 2 * w], dp[8 * kk + 2 * w + 1]);
    }
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      Wgmma<T, D>::rs_tb(acc, sa[kk], desc_sw128(kt + kk * 16 * 128, kBK * 128, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) fence_regs(sa[kk]);
    if (tid == 0) mbar_arrive(&empty[st]);  // the warpgroup is done with the stage
  }

  // epilogue: dQ in T through dq's strides; rows past sq are not stored
  store_rows<T, D>(static_cast<T*>(p.dq) + ib * p.dq_s[0] + ih * p.dq_s[1], p.dq_s[2], acc, row,
                   p.sq, col);
}

// ---- K10 / K11: dK, dV (and dQ by atomics) on Hopper ---------------------------

// Two consumer warpgroups a block: on an H100, blocks of one (the same grid)
// took 1.5x as long at the training shape and 1.7x with ALiBi and dropout at
// s = 2048 (PERF.md).
constexpr int kWG = 2;
constexpr int kStagesBwd = 4;                 // Q/dO ring depth: two stages a warpgroup
constexpr int kDkvThreads = 128 * (kWG + 1);  // the consumers, then the producer warpgroup
// the producer hands its registers to the consumers (setmaxnreg), as in qmm.cu
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert(128 * kProducerRegs + 128 * kWG * kConsumerRegs <= 65536, "register file");

// Shared memory of a K10/K11 block, from a 1024-byte aligned base: the K and
// the V tile (D / 64 sub-tiles of 64 keys x 64 columns each), the ring of
// (Q tile, dO tile) stages (the same shape), one dS^T tile (64 keys x 64
// queries) per consumer warpgroup, per stage the tile's 64 LSE, Delta,
// ALiBi slopes and positions (f32), then the barriers. The epilogue reuses
// the drained ring for the warpgroups' sums.
template <int D>
struct DkvLayout {
  static constexpr int kSub = D / 64;
  static constexpr int kTileBytes = 64 * D * 2;
  static constexpr int kRingOffset = 2 * kTileBytes;
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kDsOffset = kRingOffset + kStagesBwd * kStageBytes;
  static constexpr int kDsBytes = kBK * kBQ * 2;
  static constexpr int kAuxOffset = kDsOffset + kWG * kDsBytes;
  static constexpr int kAuxBytes = 4 * kBQ * 4;
  static constexpr int kBarOffset = kAuxOffset + kStagesBwd * kAuxBytes;
  static constexpr int kBytes = kBarOffset + 8 * (1 + 2 * kStagesBwd) + 1024;  // + alignment
  static_assert(kStagesBwd * kStageBytes >= 2 * kBK * D * 4, "the epilogue's sums fit");
  static_assert(kBytes <= 232448, "shared memory of one block");
};

// Dropout bits of a thread's 32 entries in the accumulator layout (bit i:
// entry i, key krow + 8 ((i >> 1) & 1), query q0 + 8 (i >> 2) + col + (i & 1),
// was dropped). The four lanes with the same lane % 4 and (lane / 4) / 4
// need the same 32 Philox calls (their keys share one group of four; each
// takes the word of its key), so each makes 8 of them, packs the 4 drop
// bits of each, and the lanes trade the packed words.
__device__ __forceinline__ uint32_t dropout_bits_t(const XfaExtras& ex, int ib, int ih, int q0,
                                                   int krow, int col, int lane) {
  const int m = (lane >> 2) & 3;  // this lane's word: its keys are 4 (group) + m
  uint32_t made = 0;              // bit 4 l + w: word w of call 8 m + l dropped
#pragma unroll 1
  for (int l = 0; l < 8; ++l) {
    const int i = 8 * m + l;
    const uint4 w = dropout_words(ex, ib, ih, q0 + 8 * (i >> 2) + col + (i & 1),
                                  krow - m + 8 * ((i >> 1) & 1));
    made |= ((w.x >= ex.drop_thresh ? 0u : 1u) | (w.y >= ex.drop_thresh ? 0u : 2u) |
             (w.z >= ex.drop_thresh ? 0u : 4u) | (w.w >= ex.drop_thresh ? 0u : 8u))
            << (4 * l);
  }
  uint32_t dropped = 0;
#pragma unroll
  for (int o = 0; o < 4; ++o) {
    const uint32_t part = __shfl_sync(0xffffffffu, made, (lane & ~12) | (o << 2));
#pragma unroll
    for (int l = 0; l < 8; ++l) dropped |= ((part >> (4 * l + m)) & 1u) << (8 * o + l);
  }
  return dropped;
}

template <typename T, int D, bool kFused, bool kExtra>
__global__ void __launch_bounds__(kDkvThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do, const BwdParams p,
                         const XfaExtras ex) {
  using L = DkvLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStagesBwd;
  unsigned char* k_tile = smem;
  unsigned char* v_tile = smem + L::kTileBytes;
  auto q_tile = [&](int st) { return smem + L::kRingOffset + st * L::kStageBytes; };
  auto do_tile = [&](int st) { return q_tile(st) + L::kTileBytes; };
  auto aux = [&](int st) {  // LSE, Delta, ALiBi slopes, positions of the stage's 64 rows
    return reinterpret_cast<float*>(smem + L::kAuxOffset + st * L::kAuxBytes);
  };

  // heaviest first: key tile 0 of every (batch, kv head) launches first
  const int nbh = p.b * p.h_k;
  const int ik = static_cast<int>(blockIdx.x) / nbh;
  const int ihk = static_cast<int>(blockIdx.x) % nbh % p.h_k;
  const int ib = static_cast<int>(blockIdx.x) % nbh / p.h_k;
  const int group = p.h / p.h_k;
  const int k0 = ik * kBK;
  Mask mask = make_mask(ib, p.sq, p.sk, p.wl, p.wr, p.kv_lens, p.qseg, p.kseg, ex);
  if constexpr (!kExtra) mask.qpos = mask.kpos = nullptr;

  // the block's pairs: every q head of the group, and the q tiles that can
  // see its keys (with tile tables, those whose positions and segments can
  // meet them), numbered in this order by producer and consumers alike
  int q_lo, q_hi;
  mask.query_range(k0, k0 + kBK, q_lo, q_hi);
  const int q_first = (q_lo / kBQ) * kBQ;
  auto needs = [&](int q0) {
    if constexpr (kExtra) return tiles_meet(ex, mask, ib, q0, k0);
    return true;
  };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kStagesBwd; ++st) {
      mbar_init(&full[st], 1 + 32);  // the TMA lane and the warp that writes the rows' values
      mbar_init(&empty[st], 1);      // the consuming warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kWG * 128) {  // the producer warpgroup
    setmaxnreg_dec<kProducerRegs>();
    const int pt = threadIdx.x - kWG * 128;
    if (pt == 0) {  // TMA: K and V once, then Q and dO of every pair
      mbar_arrive_expect_tx(kv_full, 2 * L::kTileBytes);
#pragma unroll
      for (int s = 0; s < L::kSub; ++s) {
        tma_load_4d(k_tile + s * kBK * 128, &tm_k, kv_full, s * 64, k0, ihk, ib);
        tma_load_4d(v_tile + s * kBK * 128, &tm_v, kv_full, s * 64, k0, ihk, ib);
      }
      int it = 0;
      for (int g = 0; g < group; ++g) {
        const int ih = ihk * group + g;
        for (int q0 = q_first; q0 < q_hi; q0 += kBQ) {
          if (!needs(q0)) continue;
          const int st = it % kStagesBwd;
          const uint32_t phase = (it / kStagesBwd) & 1;
          ++it;
          mbar_wait(&empty[st], phase ^ 1);
          mbar_arrive_expect_tx(&full[st], 2 * L::kTileBytes);
#pragma unroll
          for (int s = 0; s < L::kSub; ++s) {
            tma_load_4d(q_tile(st) + s * kBQ * 128, &tm_q, &full[st], s * 64, q0, ih, ib);
            tma_load_4d(do_tile(st) + s * kBQ * 128, &tm_do, &full[st], s * 64, q0, ih, ib);
          }
        }
      }
    } else if (pt >= 32 && pt < 64) {  // LSE (safe), Delta, ALiBi slope, position of each row
      const int lane = pt - 32;
      int it = 0;
      for (int g = 0; g < group; ++g) {
        const int ih = ihk * group + g;
        const size_t bh = static_cast<size_t>(ib) * p.h + ih;
        for (int q0 = q_first; q0 < q_hi; q0 += kBQ) {
          if (!needs(q0)) continue;
          const int st = it % kStagesBwd;
          const uint32_t phase = (it / kStagesBwd) & 1;
          ++it;
          mbar_wait(&empty[st], phase ^ 1);
          float* a = aux(st);
#pragma unroll
          for (int i = lane; i < kBQ; i += 32) {
            const int qi = q0 + i;
            const bool live = qi < p.sq;  // rows past sq: P = 0
            a[i] = live ? safe_lse(p.lse[bh * p.sq + qi]) : 3.0e38f;
            a[kBQ + i] = live ? p.delta[bh * p.sq + qi] : 0.f;
            if constexpr (kExtra) {
              a[2 * kBQ + i] = alibi_slope(ex, ib, ih, p.h, p.sq, qi);
              a[3 * kBQ + i] = static_cast<float>(mask.qp(qi));  // as Mask::dist reads it
            }
          }
          mbar_arrive(&full[st]);
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroups: wg takes pairs wg, wg + 2, ... ----
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int krow = k0 + warp * 16 + (lane >> 2);  // this thread's keys: krow, krow + 8
  const int col = (lane & 3) * 2;                 // its query columns in an 8-column group
  const bool dropout = kExtra && ex.drop_thresh != 0;
  const float drop_scale = kExtra ? ex.drop_scale : 1.f;
  const bool general = kExtra || p.softcap > 0.f;  // else no softcap, ALiBi or dropout
  const bool alibi = kExtra && (ex.alibi != nullptr || ex.row_slopes != nullptr);
  // the positions of this thread's keys, for the ALiBi distance
  const float kpos_f[2] = {static_cast<float>(mask.kp(krow)),
                           static_cast<float>(mask.kp(krow + 8))};
  const float scale_log2 = p.scale * kLog2e;
  unsigned char* ds_tile = smem + L::kDsOffset + wg * L::kDsBytes;

  float dk[D / 2], dv[D / 2];  // (64 keys x D): 8-column group n holds [4n .. 4n+3]
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  float s[kBQ / 2], dp[kBQ / 2];  // S^T then P^T, dP^T then dS^T: (64 keys x 64 queries)
#pragma unroll
  for (int i = 0; i < kBQ / 2; ++i) s[i] = dp[i] = 0.f;

  mbar_wait(kv_full, 0);
  int it = 0;
  for (int g = 0; g < group; ++g) {
    const int ih = ihk * group + g;
    for (int q0 = q_first; q0 < q_hi; q0 += kBQ) {
      if (!needs(q0)) continue;
      const int mine = it++;
      if (mine % kWG != wg) continue;
      const int st = mine % kStagesBwd;
      mbar_wait(&full[st], (mine / kStagesBwd) & 1);
      const unsigned char* qt = q_tile(st);
      const unsigned char* dot = do_tile(st);

      // S^T = K Q^T and dP^T = V dO^T, both operands K-major
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk / 4) * 64 * 128 + (kk % 4) * 32;
        Wgmma<T, kBQ>::ss(s, desc_sw128(k_tile + off, 16, 1024), desc_sw128(qt + off, 16, 1024),
                          kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk / 4) * 64 * 128 + (kk % 4) * 32;
        Wgmma<T, kBQ>::ss(dp, desc_sw128(v_tile + off, 16, 1024), desc_sw128(dot + off, 16, 1024),
                          kk > 0);
      }
      wgmma_commit();

      // P^T and dS^T per entry: element i is key krow + 8 ((i >> 1) & 1),
      // query q0 + 8 (i >> 2) + col + (i & 1)
      const float* lse_s = aux(st);
      const float* delta_s = lse_s + kBQ;
      const float* slope_s = lse_s + 2 * kBQ;
      const float* qpos_s = lse_s + 3 * kBQ;
      const bool inner = tile_interior<kExtra>(mask, ex, ib, q0, k0);
      if (!general) {
        wgmma_wait<1>();  // S^T is ready; dP^T may still run
        fence_regs(s);
#pragma unroll
        for (int j = 0; j < kBQ / 8; ++j) {
          const float2 l = *reinterpret_cast<const float2*>(lse_s + 8 * j + col);
          const float l2[2] = {l.x * kLog2e, l.y * kLog2e};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            float pv = exp2f(fmaf(s[i], scale_log2, -l2[e & 1]));
            if (!inner && !mask.keep(q0 + 8 * j + col + (e & 1), krow + 8 * (e >> 1))) pv = 0.f;
            s[i] = pv;
          }
        }
        wgmma_wait<0>();
        fence_regs(dp);
#pragma unroll
        for (int j = 0; j < kBQ / 8; ++j) {
          const float2 dl = *reinterpret_cast<const float2*>(delta_s + 8 * j + col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            dp[i] = s[i] * (dp[i] - ((e & 1) ? dl.y : dl.x)) * p.scale;
          }
        }
      } else {
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        // bit i: entry i is masked, and dropped; rolled loops, to keep the
        // registers for the accumulators
        uint32_t masked = 0, dropped = 0;
        if (!inner) {
#pragma unroll 1
          for (int i = 0; i < kBQ / 2; ++i)
            if (!mask.keep(q0 + 8 * (i >> 2) + col + (i & 1), krow + 8 * ((i >> 1) & 1)))
              masked |= 1u << i;
        }
        if (dropout) dropped = dropout_bits_t(ex, ib, ih, q0, krow, col, lane);
#pragma unroll
        for (int i = 0; i < kBQ / 2; ++i) {
          const int qc = 8 * (i >> 2) + col + (i & 1);
          const float bias = alibi ? slope_s[qc] * fabsf(qpos_s[qc] - kpos_f[(i >> 1) & 1]) : 0.f;
          const float z = (dropped >> i) & 1 ? 0.f : drop_scale;
          recompute_p_ds(s[i], dp[i], lse_s[qc], delta_s[qc], !((masked >> i) & 1), p.scale,
                         p.softcap, bias, z, s[i], dp[i]);
        }
      }

      // dV += P^T dO (P rounded to dO's dtype), dK += dS^T Q (dS to Q's dtype):
      // A from registers, B MN-major from the ring
      uint32_t pa[kBQ / 16][4], sa[kBQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          pa[kk][w] = Mma<T>::pack(s[8 * kk + 2 * w], s[8 * kk + 2 * w + 1]);
          sa[kk][w] = Mma<T>::pack(dp[8 * kk + 2 * w], dp[8 * kk + 2 * w + 1]);
        }
      }
      fence_regs(dk);
      fence_regs(dv);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk)
        Wgmma<T, D>::rs_tb(dv, pa[kk], desc_sw128(dot + kk * 16 * 128, kBQ * 128, 1024), 1);
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk)
        Wgmma<T, D>::rs_tb(dk, sa[kk], desc_sw128(qt + kk * 16 * 128, kBQ * 128, 1024), 1);
      wgmma_commit();

      if constexpr (kFused) {
        // dS^T (K's dtype is Q's) into the warpgroup's swizzled tile, keys as
        // rows: word (kk, w) holds key 16 warp + lane / 4 + 8 (w & 1) and
        // queries 16 kk + 8 (w >> 1) + col, col + 1
#pragma unroll
        for (int kk = 0; kk < kBQ / 16; ++kk) {
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const int kr = warp * 16 + (lane >> 2) + 8 * (w & 1);
            const int chunk = (2 * kk + (w >> 1)) ^ (lane >> 2);  // kr % 8 == lane / 4
            *reinterpret_cast<uint32_t*>(ds_tile + kr * 128 + chunk * 16 + col * 2) = sa[kk][w];
          }
        }
        fence_proxy_async();
        named_barrier_sync(1 + wg, 128);
      }
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
        fence_regs(pa[kk]);
        fence_regs(sa[kk]);
      }
      if (tid == 0) mbar_arrive(&empty[st]);  // the warpgroup is done with the stage

      if constexpr (kFused) {
        // dQ (64 queries x D) = dS K, 64 columns at a time (the accumulators of
        // all D columns beside dK and dV spilled): A = the dS^T tile, B = a
        // 64-column sub-tile of K, both MN-major; then added to the f32 buffer
        float* dqb = static_cast<float*>(p.dq) + ib * p.dq_s[0] + ih * p.dq_s[1];
#pragma unroll
        for (int half = 0; half < D / 64; ++half) {
          float dq[32];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk)
            Wgmma<T, 64>::ss_tt(dq, desc_sw128(ds_tile + kk * 16 * 128, kBQ * 128, 1024),
                                desc_sw128(k_tile + half * kBK * 128 + kk * 16 * 128, kBK * 128,
                                           1024),
                                kk > 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dq);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int qi = q0 + warp * 16 + (lane >> 2) + 8 * r;
            if (qi >= p.sq) continue;
#pragma unroll
            for (int n = 0; n < 8; ++n)
              atomicAdd(reinterpret_cast<float2*>(dqb + qi * p.dq_s[2] + half * 64 + n * 8 + col),
                        make_float2(dq[4 * n + 2 * r], dq[4 * n + 2 * r + 1]));
          }
        }
      }
    }
  }

  // epilogue: the warpgroups' sums added once each through the drained ring
  // (warpgroup 0 ends with dK, warpgroup 1 with dV), then stored in T
  float* red = reinterpret_cast<float*>(smem + L::kRingOffset);
  named_barrier_sync(3, 256);  // both warpgroups are done with the ring
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) red[i * 128 + tid] = dv[i];
  } else {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) red[(D / 2 + i) * 128 + tid] = dk[i];
  }
  named_barrier_sync(3, 256);
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] += red[(D / 2 + i) * 128 + tid];
    store_rows<T, D>(static_cast<T*>(p.dk) + ib * p.dk_s[0] + ihk * p.dk_s[1], p.dk_s[2], dk,
                     krow, p.sk, col);
  } else {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dv[i] += red[i * 128 + tid];
    store_rows<T, D>(static_cast<T*>(p.dv) + ib * p.dv_s[0] + ihk * p.dv_s[1], p.dv_s[2], dv,
                     krow, p.sk, col);
  }
}

// ---- launches ----------------------------------------------------------------

// The tensor maps of q, k, v and dO over the caller's strides: 64 x 64
// boxes, 128-byte swizzle. A side with no row (sq = 0 for K10/K11, sk = 0
// for K9) is never loaded, and its maps take the other side's valid extents.
template <typename T, int D>
cudaError_t make_maps(const BwdArgs& a, CUtensorMap (&maps)[4]) {
  const bool f16 = std::is_same<T, __half>::value;
  const bool q_rows = a.sq > 0, k_rows = a.sk > 0;
  const Operand ops[4] = {q_rows ? kQ : kK, k_rows ? kK : kQ, k_rows ? kV : kQ,
                          q_rows ? kDO : kK};
  const void* bases[kOperands] = {a.q, a.k, a.v, a.dout};
  for (int i = 0; i < 4; ++i) {
    const Operand o = ops[i];
    const bool kv = o == kK || o == kV;
    const uint64_t dims[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(kv ? a.sk : a.sq),
                              static_cast<uint64_t>(kv ? a.h_k : a.h),
                              static_cast<uint64_t>(a.b)};
    const uint64_t bytes[3] = {static_cast<uint64_t>(a.st[o][2]) * 2,
                               static_cast<uint64_t>(a.st[o][1]) * 2,
                               static_cast<uint64_t>(a.st[o][0]) * 2};
    cudaError_t err = make_map_4d(&maps[i], f16, bases[o], dims, bytes, 64, 64);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The kernels' parameters; dq is K9's output or K11's f32 buffer, with its
// strides at the dq slot.
BwdParams make_params(const BwdArgs& a, void* dq, void* dk, void* dv) {
  BwdParams prm{};
  prm.lse = static_cast<const float*>(a.lse);
  prm.delta = static_cast<const float*>(a.delta);
  prm.dq = dq;
  prm.dk = dk;
  prm.dv = dv;
  for (int j = 0; j < 3; ++j) {
    prm.dq_s[j] = a.st[kDQ][j];
    prm.dk_s[j] = a.st[kDK][j];
    prm.dv_s[j] = a.st[kDV][j];
  }
  prm.kv_lens = a.kv_lens;
  prm.qseg = a.qseg;
  prm.kseg = a.kseg;
  prm.b = a.b;
  prm.h = a.h;
  prm.h_k = a.h_k;
  prm.sq = a.sq;
  prm.sk = a.sk;
  prm.wl = a.wl;
  prm.wr = a.wr;
  prm.scale = a.scale;
  prm.softcap = a.softcap;
  return prm;
}

template <typename T, int D>
cudaError_t launch_dq(const BwdArgs& a, cudaStream_t stream) {
  using L = DqLayout<D>;
  CUtensorMap maps[4];
  cudaError_t err = make_maps<T, D>(a, maps);
  if (err != cudaSuccess) return err;
  const BwdParams prm = make_params(a, a.dq, nullptr, nullptr);
  auto* kernel = has_extras(a.ex) ? &flash_bwd_dq_kernel<T, D, true>
                                  : &flash_bwd_dq_kernel<T, D, false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((a.sq + kBQ - 1) / kBQ) * a.h * a.b;
  kernel<<<grid, kDqThreads, L::kBytes, stream>>>(maps[0], maps[1], maps[2], maps[3], prm, a.ex);
  return cudaGetLastError();
}

template <typename T, int D, bool kFused>
cudaError_t launch_dkv(const BwdArgs& a, float* dq_acc, void* dk, void* dv,
                       cudaStream_t stream) {
  using L = DkvLayout<D>;
  CUtensorMap maps[4];
  cudaError_t err = make_maps<T, D>(a, maps);
  if (err != cudaSuccess) return err;
  const BwdParams prm = make_params(a, dq_acc, dk, dv);
  auto* kernel = has_extras(a.ex) ? &flash_bwd_dkv_kernel<T, D, kFused, true>
                                  : &flash_bwd_dkv_kernel<T, D, kFused, false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((a.sk + kBK - 1) / kBK) * a.h_k * a.b;
  kernel<<<grid, kDkvThreads, L::kBytes, stream>>>(maps[0], maps[1], maps[2], maps[3], prm, a.ex);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv_d(const BwdArgs& a, float* dq_acc, void* dk, void* dv, bool fused,
                         cudaStream_t stream) {
  return fused ? launch_dkv<T, D, true>(a, dq_acc, dk, dv, stream)
               : launch_dkv<T, D, false>(a, dq_acc, dk, dv, stream);
}

BwdArgs make_args(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, void* dq, const void* kv_lens,
                  const void* q_seg, const void* kv_seg, int b, int h, int h_k, int sq, int sk,
                  int wl, int wr, float scale, float softcap, const XfaExtras& ex,
                  const int64_t* strides) {
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  a.kv_lens = static_cast<const int32_t*>(kv_lens);
  a.qseg = static_cast<const int32_t*>(q_seg);
  a.kseg = static_cast<const int32_t*>(kv_seg);
  for (int o = 0; o < kOperands; ++o)
    for (int j = 0; j < 3; ++j) a.st[o][j] = strides[3 * o + j];
  a.b = b;
  a.h = h;
  a.h_k = h_k;
  a.sq = sq;
  a.sk = sk;
  a.wl = wl;
  a.wr = wr;
  a.scale = scale;
  a.softcap = softcap;
  a.ex = ex;
  return a;
}

bool valid(int dtype, int d, int h, int h_k, const void* q_seg, const void* kv_seg,
           const XfaExtras* ex, const int64_t* strides) {
  return (dtype == XFA_BF16 || dtype == XFA_F16) && (d == 64 || d == 128) && h_k > 0 &&
         h % h_k == 0 && (q_seg == nullptr) == (kv_seg == nullptr) && ex != nullptr &&
         strides != nullptr && (ex->qpos == nullptr) == (ex->kpos == nullptr) &&
         (ex->qtiles == nullptr) == (ex->ktiles == nullptr);
}

}  // namespace

// Arguments of both entry points: q, dout (b, h, sq, d); k, v (b, h_k, sk, d);
// bf16 (XFA_BF16) or fp16 (XFA_F16), d 64 or 128, each with its last
// dimension contiguous and its (batch, head, row) element strides in
// `strides` (int64, in the order q, k, v, dout, dq, dk, dv: three each, the
// outputs' too; the inputs' multiples of 8 with 16-byte aligned bases, the
// tensor maps' rule), q NOT pre-scaled; lse, delta (b, h, sq) f32
// contiguous; kv_lens (b,), q_seg (b, sq), kv_seg (b, sk) int32 or null;
// wl / wr the window (< 0 unbounded); extras (ALiBi, positions, tile tables,
// dropout; flash_common.cuh) in host memory.

// K9: writes dq (b, h, sq, d) in the input dtype.
extern "C" int xfa_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dq,
                                const void* kv_lens, const void* q_seg, const void* kv_seg,
                                int dtype, int b, int h, int h_k, int sq, int sk, int d, int wl,
                                int wr, float scale, float softcap, const flash::XfaExtras* extras,
                                const int64_t* strides, void* stream) {
  if (!valid(dtype, d, h, h_k, q_seg, kv_seg, extras, strides)) return cudaErrorInvalidValue;
  if (b * h * sq == 0) return cudaSuccess;
  const BwdArgs a = make_args(q, k, v, dout, lse, delta, dq, kv_lens, q_seg, kv_seg, b, h, h_k,
                              sq, sk, wl, wr, scale, softcap, *extras, strides);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == XFA_BF16)
    return d == 128 ? launch_dq<__nv_bfloat16, 128>(a, st) : launch_dq<__nv_bfloat16, 64>(a, st);
  return d == 128 ? launch_dq<__half, 128>(a, st) : launch_dq<__half, 64>(a, st);
}

// K10 (fused = 0): writes dk, dv (b, h_k, sk, d) in the input dtype.
// K11 (fused = 1): also adds dQ into dq_acc (b, h, sq, d) f32 (strides at the
// dq slot, multiples of 2), which the caller zeroes before and casts after.
extern "C" int xfa_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dk, void* dv,
                                 void* dq_acc, const void* kv_lens, const void* q_seg,
                                 const void* kv_seg, int dtype, int b, int h, int h_k, int sq,
                                 int sk, int d, int wl, int wr, float scale, float softcap,
                                 const flash::XfaExtras* extras, int fused,
                                 const int64_t* strides, void* stream) {
  if (!valid(dtype, d, h, h_k, q_seg, kv_seg, extras, strides)) return cudaErrorInvalidValue;
  if (fused && dq_acc == nullptr) return cudaErrorInvalidValue;
  if (b * h_k * sk == 0) return cudaSuccess;
  const BwdArgs a = make_args(q, k, v, dout, lse, delta, nullptr, kv_lens, q_seg, kv_seg, b, h,
                              h_k, sq, sk, wl, wr, scale, softcap, *extras, strides);
  auto st = static_cast<cudaStream_t>(stream);
  float* acc = static_cast<float*>(dq_acc);
  const bool f = fused != 0;
  if (dtype == XFA_BF16)
    return d == 128 ? launch_dkv_d<__nv_bfloat16, 128>(a, acc, dk, dv, f, st)
                    : launch_dkv_d<__nv_bfloat16, 64>(a, acc, dk, dv, f, st);
  return d == 128 ? launch_dkv_d<__half, 128>(a, acc, dk, dv, f, st)
                  : launch_dkv_d<__half, 64>(a, acc, dk, dv, f, st);
}
