// Dense flash-attention forward (K7): O and the log-sum-exp of every query row.
//
// Replaces the TPU kernel xf_flash_attention_cutlass_tpu/ops/flash_fwd.py
// `_flash_fwd_kernel` (:100). The TPU kernel runs its grid in order and keeps
// the online-softmax state (m, l, O) in VMEM scratch across the sequential KV
// grid axis; a sparse table of live (q, kv) block pairs skips fully masked
// blocks. Here one block owns one (batch, q head, 64-row q tile) and walks
// the live 64-key tiles in a loop; its bounds come from the causal / window
// geometry and kv_lens, so masked tiles are never loaded.
//
// Design for Hopper (hopper.cuh):
// - One producer warp issues TMA loads: the Q tile once, then the K and V
//   tiles of every live key tile into a ring of kStages stages with full and
//   empty mbarriers. The tensor maps take the caller's strides, so q, k, v
//   may be (b, s, h, d) views; TMA zero-fills rows past sq and sk.
// - One consumer warpgroup owns the 64 query rows. It first multiplies the
//   Q tile in shared memory by the softmax scale (f32 product rounded to the
//   input dtype, as the plain version does), then per key tile: S = Q K^T by
//   wgmma (both operands K-major in shared memory), the online softmax in
//   registers, and O += P V by wgmma with P from registers (the S
//   accumulators repacked as the A operand) and V read as an MN-major B
//   operand, so V is never transposed. Two blocks fit on an
//   SM, so one block's softmax overlaps the other's products. (128-row
//   blocks of two consumer warpgroups sharing each K/V tile, one block an
//   SM, were slower on the card on every causal shape timed.)
// - The accumulator layout is the mma.sync C layout in each warp's 16 rows
//   (hopper.cuh), so the mask, ALiBi distance and dropout bits of
//   flash_common.cuh apply per entry with row = first row + 16 warp + lane/4.
// - Per-entry masking runs only on boundary tiles (the diagonal, window
//   edges, the kv_len edge, segment or tile-table boundaries); interior tiles
//   take the unmasked path. exp is exp2 with log2(e) folded into one FMA.
// - Blocks run heaviest first: the last q tiles (most keys under a causal
//   mask) of every (batch, head) launch first (ops/flash_fwd.py
//   fwd_block_order).
//
// Numerics follow the TPU kernel: q is multiplied by the softmax scale in f32
// and rounded to its dtype before the product, masked scores are the finite
// NEG_INF, the running max has the floor -1e30, the tanh softcap acts on the
// scaled scores, ALiBi subtracts slope * |qpos - kpos| after it, P is rounded
// to V's dtype for the product, O = acc * (1 / l), and rows that see no key
// give O = 0 and LSE = -inf (natural log). Dropout zeroes P after the row sum
// (the mask is flash_common.cuh's Philox, keyed by batch, q head, row and
// key, so K9-K11 replay it) and O takes 1 / (1 - p) in the epilogue.
//
// The options (ALiBi, explicit positions, tile tables, dropout) live in the
// kExtra instantiation only, so the option-free kernel pays nothing for
// them. With explicit positions the index geometry no longer bounds the key
// loop: the block walks every key tile below kv_len and skips the tiles
// whose positions and segment ids (from the wrapper's 64-entry tile tables)
// cannot meet its rows'.
//
// Bound on an H100: operations. A causal tile pair costs 4 * 64 * 64 * d
// tensor-core operations against 2 * 64 * d * 2 bytes of K and V, far above
// the card's ~295 operations per byte. Not yet done: overlapping one tile's
// softmax with the next tile's products inside a warpgroup, and sharing K/V
// tiles among the q heads of a GQA group.
#include <limits.h>

#include <type_traits>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;
using namespace hopper;

constexpr int kBQ = 64;     // query rows per block: one consumer warpgroup
constexpr int kBK = 64;     // keys per tile (= kTile of the tile tables)
constexpr int kStages = 2;  // K/V ring depth
constexpr int kThreadsFwd = 128 + 32;  // the consumer warpgroup and the producer warp
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kBK == kTile, "the tile tables are per 64 keys");

__device__ __forceinline__ float as_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float as_float(__half x) { return __half2float(x); }

// Shared memory of one block, from a 1024-byte aligned base: the Q tile as
// D / 64 sub-tiles of (kBQ rows x 64 columns), then per stage the K and the
// V tile as D / 64 sub-tiles of (kBK x 64) each, then the barriers.
template <int D>
struct Layout {
  static constexpr int kSub = D / 64;
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kTileBytes = kBK * D * 2;
  static constexpr int kStageBytes = 2 * kTileBytes;  // K and V
  static constexpr int kBarOffset = kQBytes + kStages * kStageBytes;
  static constexpr int kBytes = kBarOffset + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack
};

struct FwdParams {
  void* o;
  int64_t o_sb, o_sh, o_ss;  // O's strides in elements (batch, head, row)
  float* lse;                // (b, h, sq)
  const int32_t* kv_lens;
  const int32_t* qseg;
  const int32_t* kseg;
  int b, h, h_k, sq, sk, wl, wr, n_qt;
  float softcap, scale;
};

// Whether every entry of (rows [r0, r0 + 64), keys [k0, k0 + kBK)) that a
// valid row holds is visible: then the tile needs no per-entry mask.
template <bool kExtra>
__device__ __forceinline__ bool interior(const Mask& m, const XfaExtras& ex, int ib, int r0,
                                         int k0) {
  if (k0 + kBK > m.kv_len) return false;
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
  if (m.wr >= 0 && k0 + kBK - 1 > r0 + m.offset + m.wr) return false;
  if (m.wl >= 0 && k0 < r0 + kBQ - 1 + m.offset - m.wl) return false;
  return true;
}

template <typename T, int D, bool kExtra>
__global__ void __launch_bounds__(kThreadsFwd, 2)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const FwdParams p,
                     const XfaExtras ex) {
  using L = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;
  auto k_tile = [&](int st) { return smem + L::kQBytes + st * L::kStageBytes; };
  auto v_tile = [&](int st) { return smem + L::kQBytes + st * L::kStageBytes + L::kTileBytes; };

  // heaviest first: the last q tiles of every (batch, head) launch first
  const int nbh = p.b * p.h;
  const int iq = p.n_qt - 1 - static_cast<int>(blockIdx.x) / nbh;
  const int ih = static_cast<int>(blockIdx.x) % nbh % p.h;
  const int ib = static_cast<int>(blockIdx.x) % nbh / p.h;
  const int ihk = ih / (p.h / p.h_k);
  const int q0 = iq * kBQ;
  Mask mask = make_mask(ib, p.sq, p.sk, p.wl, p.wr, p.kv_lens, p.qseg, p.kseg, ex);
  if constexpr (!kExtra) mask.qpos = mask.kpos = nullptr;

  // the key tiles the rows can see; with tile tables, those whose positions
  // and segments can meet the rows'
  int k_lo, k_hi;
  mask.key_range(q0, min(q0 + kBQ, p.sq), k_lo, k_hi);
  const int k_first = (k_lo / kBK) * kBK;
  auto needs = [&](int k0) {
    if constexpr (kExtra) return tiles_meet(ex, mask, ib, q0, k0);
    return true;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 1);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // the producer warp; one lane issues
    if (threadIdx.x == 128) {
      mbar_arrive_expect_tx(q_full, L::kQBytes);
#pragma unroll
      for (int s = 0; s < L::kSub; ++s)
        tma_load_4d(smem + s * kBQ * 128, &tm_q, q_full, s * 64, q0, ih, ib);
      int it = 0;
      for (int k0 = k_first; k0 < k_hi; k0 += kBK) {
        if (!needs(k0)) continue;
        const int st = it % kStages;
        const uint32_t phase = (it / kStages) & 1;
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

  // ---- the consumer warpgroup ----
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int row = q0 + warp * 16 + (lane >> 2);  // and row + 8
  const int col = (lane & 3) * 2;

  // the softmax scale, in f32 and rounded to T, on the Q tile
  mbar_wait(q_full, 0);
#pragma unroll
  for (int s = 0; s < L::kSub; ++s) {
    uint4* base = reinterpret_cast<uint4*>(smem + s * kBQ * 128);
    for (int i = tid; i < kBQ * 8; i += 128) {
      uint4 w = base[i];
      T* e = reinterpret_cast<T*>(&w);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = Mma<T>::from_float(as_float(e[j]) * p.scale);
      base[i] = w;
    }
  }
  fence_proxy_async();
  named_barrier_sync(1, 128);

  float acc[D / 2];  // O: 8-column group n holds acc[4n .. 4n+3]
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[kBK / 2];  // S, then P, of one key tile
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) s[i] = 0.f;
  float m_row[2] = {kMFloor, kMFloor};
  float l_row[2] = {0.f, 0.f};  // this thread's part of the row sums
  float slope[2] = {0.f, 0.f};
  bool alibi = false;
  if constexpr (kExtra) {
    alibi = ex.alibi != nullptr || ex.row_slopes != nullptr;
    slope[0] = alibi_slope(ex, ib, ih, p.h, p.sq, row);
    slope[1] = alibi_slope(ex, ib, ih, p.h, p.sq, row + 8);
  }
  int it = 0;
  for (int k0 = k_first; k0 < k_hi; k0 += kBK) {
    if (!needs(k0)) continue;
    const int st = it % kStages;
    const uint32_t phase = (it / kStages) & 1;
    ++it;
    mbar_wait(&full[st], phase);
    // S = Q K^T
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t da =
          desc_sw128(smem + (kk / 4) * kBQ * 128 + (kk % 4) * 32, 16, 1024);
      const uint64_t db = desc_sw128(k_tile(st) + (kk / 4) * kBK * 128 + (kk % 4) * 32, 16, 1024);
      Wgmma<T, kBK>::ss(s, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // softcap, ALiBi, and the mask on boundary tiles only
    if (p.softcap > 0.f) {
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) s[i] = tanhf(s[i] / p.softcap) * p.softcap;
    }
    if constexpr (kExtra) {
      if (alibi) {
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i)
          s[i] -= slope[(i >> 1) & 1] *
                  mask.dist(row + 8 * ((i >> 1) & 1), k0 + (i >> 2) * 8 + col + (i & 1));
      }
    }
    if (!interior<kExtra>(mask, ex, ib, q0, k0)) {
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i)
        if (!mask.keep(row + 8 * ((i >> 1) & 1), k0 + (i >> 2) * 8 + col + (i & 1)))
          s[i] = kNegInf;
    }

    // the online-softmax update of both rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_row[r], mx);
      const float corr = exp2f((m_row[r] - m_new) * kLog2e);  // exactly 1 when m holds
      const float m_l2 = m_new * kLog2e;
      m_row[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        s[4 * j + 2 * r] = exp2f(fmaf(s[4 * j + 2 * r], kLog2e, -m_l2));
        s[4 * j + 2 * r + 1] = exp2f(fmaf(s[4 * j + 2 * r + 1], kLog2e, -m_l2));
        sum += s[4 * j + 2 * r] + s[4 * j + 2 * r + 1];
      }
      l_row[r] = l_row[r] * corr + sum;
      if constexpr (kExtra) {  // dropout: P leaves the sum whole, the product without
        if (ex.drop_thresh != 0) {
#pragma unroll
          for (int j = 0; j < kBK / 8; ++j) {
            bool keep0, keep1;
            dropout_keep2(ex, ib, ih, row + 8 * r, k0 + j * 8 + col, keep0, keep1);
            if (!keep0) s[4 * j + 2 * r] = 0.f;
            if (!keep1) s[4 * j + 2 * r + 1] = 0.f;
          }
        }
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[4 * n + 2 * r] *= corr;
        acc[4 * n + 2 * r + 1] *= corr;
      }
    }

    // O += P V, P rounded to V's dtype and packed as the A operand
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int w = 0; w < 4; ++w)
        pa[kk][w] = Mma<T>::pack(s[8 * kk + 2 * w], s[8 * kk + 2 * w + 1]);
    }
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t db = desc_sw128(v_tile(st) + kk * 16 * 128, kBK * 128, 1024);
      Wgmma<T, D>::rs_tb(acc, pa[kk], db, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) fence_regs(pa[kk]);
    if (tid == 0) mbar_arrive(&empty[st]);  // the warpgroup is done with the stage
  }

  // epilogue: the four threads of a row hold parts of its sum
  const float drop_scale = kExtra ? ex.drop_scale : 1.f;
  const size_t bh = static_cast<size_t>(ib) * p.h + ih;
  T* o = static_cast<T*>(p.o) + ib * p.o_sb + ih * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_row[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int qi = row + r * 8;
    if (qi >= p.sq) continue;
    const bool no_key = l <= 0.f;
    const float inv = no_key ? 1.f : 1.f / l;
    T* orow = o + qi * p.o_ss;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float x0 = no_key ? 0.f : acc[4 * n + 2 * r] * inv * drop_scale;
      const float x1 = no_key ? 0.f : acc[4 * n + 2 * r + 1] * inv * drop_scale;
      *reinterpret_cast<uint32_t*>(orow + n * 8 + col) = Mma<T>::pack(x0, x1);
    }
    if ((lane & 3) == 0) p.lse[bh * p.sq + qi] = no_key ? -INFINITY : m_row[r] + logf(l);
  }
}

// strides: q, k, v and o, each (batch, head, row) in elements
template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int64_t* strides,
                   FwdParams prm, const XfaExtras& ex, cudaStream_t stream) {
  using L = Layout<D>;
  const bool f16 = std::is_same<T, __half>::value;
  CUtensorMap maps[3];
  const void* bases[3] = {q, k, v};
  // no key (sk = 0): no tile is loaded, but the maps must still be valid
  const int rows[3] = {prm.sq, max(prm.sk, 1), max(prm.sk, 1)};
  const int heads[3] = {prm.h, prm.h_k, prm.h_k};
  const uint32_t box_rows[3] = {kBQ, kBK, kBK};
  for (int i = 0; i < 3; ++i) {
    const int64_t* st = strides + 3 * (prm.sk > 0 ? i : 0);
    const uint64_t dims[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(rows[i]),
                              static_cast<uint64_t>(heads[i]), static_cast<uint64_t>(prm.b)};
    const uint64_t bytes[3] = {static_cast<uint64_t>(st[2]) * 2, static_cast<uint64_t>(st[1]) * 2,
                               static_cast<uint64_t>(st[0]) * 2};
    cudaError_t err = make_map_4d(&maps[i], f16, prm.sk > 0 ? bases[i] : q, dims, bytes, 64,
                                  box_rows[i]);
    if (err != cudaSuccess) return err;
  }
  prm.o_sb = strides[9];
  prm.o_sh = strides[10];
  prm.o_ss = strides[11];
  prm.n_qt = (prm.sq + kBQ - 1) / kBQ;
  auto* kernel = has_extras(ex) ? &flash_fwd_kernel<T, D, true> : &flash_fwd_kernel<T, D, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>(prm.n_qt) * prm.h * prm.b;
  kernel<<<grid, kThreadsFwd, L::kBytes, stream>>>(maps[0], maps[1], maps[2], prm, ex);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int d, const void* q, const void* k, const void* v, const int64_t* strides,
                     const FwdParams& prm, const XfaExtras& ex, cudaStream_t stream) {
  if (d == 128) return launch<T, 128>(q, k, v, strides, prm, ex, stream);
  if (d == 64) return launch<T, 64>(q, k, v, strides, prm, ex, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (b, h, sq, d), k and v (b, h_k, sk, d) bf16 (dtype XFA_BF16) or fp16
// (XFA_F16), d 64 or 128, each with its last dimension contiguous and its
// (batch, head, row) strides in elements at strides[0..2] (q), [3..5] (k),
// [6..8] (v): multiples of 8, bases 16-byte aligned (the tensor maps' rule).
// q is not pre-scaled: the kernel multiplies it by `scale`. Writes o (b, h,
// sq, d) with strides[9..11] and lse (b, h, sq) f32 contiguous. kv_lens (b,),
// q_seg (b, sq) and kv_seg (b, sk) int32 may be null. wl / wr: window, < 0
// unbounded. extras: ALiBi, positions, tile tables and dropout
// (flash_common.cuh), host memory.
extern "C" int xfa_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                             const void* kv_lens, const void* q_seg, const void* kv_seg,
                             int dtype, int b, int h, int h_k, int sq, int sk, int d,
                             int wl, int wr, float softcap, float scale,
                             const int64_t* strides, const flash::XfaExtras* extras,
                             void* stream) {
  if (h_k <= 0 || h % h_k != 0 || extras == nullptr || strides == nullptr)
    return cudaErrorInvalidValue;
  if ((q_seg == nullptr) != (kv_seg == nullptr)) return cudaErrorInvalidValue;
  if ((extras->qpos == nullptr) != (extras->kpos == nullptr)) return cudaErrorInvalidValue;
  if ((extras->qtiles == nullptr) != (extras->ktiles == nullptr)) return cudaErrorInvalidValue;
  if (b * h * sq == 0) return cudaSuccess;
  FwdParams prm{};
  prm.o = o;
  prm.lse = static_cast<float*>(lse);
  prm.kv_lens = static_cast<const int32_t*>(kv_lens);
  prm.qseg = static_cast<const int32_t*>(q_seg);
  prm.kseg = static_cast<const int32_t*>(kv_seg);
  prm.b = b;
  prm.h = h;
  prm.h_k = h_k;
  prm.sq = sq;
  prm.sk = sk;
  prm.wl = wl;
  prm.wr = wr;
  prm.softcap = softcap;
  prm.scale = scale;
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case XFA_BF16:
      return launch_d<__nv_bfloat16>(d, q, k, v, strides, prm, *extras, st);
    case XFA_F16:
      return launch_d<__half>(d, q, k, v, strides, prm, *extras, st);
    default:
      return cudaErrorInvalidValue;
  }
}
