// Normalized attention probabilities with the dropout mask sign-encoded (K8):
// the (b, h, sq, sk) f32 plane P = exp(S - LSE), masked entries and rows with
// LSE = -inf 0, entries the dropout dropped negated.
//
// Replaces the TPU kernel xf_flash_attention_cutlass_tpu/ops/flash_fwd.py
// `_probs_kernel` (:379, launched at :585), the debug pass behind
// `return_attn_probs`. S is K7's score: q times the softmax scale in f32,
// rounded to its dtype, the tanh softcap, then ALiBi's -slope * |qpos -
// kpos|, with K7's masks (causal / window from the bottom right or explicit
// positions, segment ids). The dropout mask is flash_common.cuh's Philox
// keyed by (seed, batch, q head, row, key), so the signs are the mask K7 and
// K9-K11 applied, whatever their tiling.
//
// Bound on an H100: bytes. The plane is 4 * b * h * sq * sk bytes of output
// (537 MB at (1, 32, 2048, 2048), 0.160 ms at 3.35 TB/s) against 2 * d
// operations per visible entry (0.017 ms causal at 989 TFLOP/s). So the
// stores must stream at the card's rate while the scores and their
// epilogue hide under them.
//
// Design for Hopper (hopper.cuh), K7's skeleton:
// - One block owns one (batch, q head, 64-row q tile) and writes every key
//   tile of its rows, heaviest row tiles first (as K7's fwd_block_order).
// - One producer warp issues TMA loads: the Q tile once, then the K tile of
//   every live key tile into a ring of full / empty mbarriers (one stage at
//   d = 128, so that three blocks fit an SM, two at d = 64; the q heads of a
//   GQA group run side by side and find K in L2).
// - One consumer warpgroup scales the Q tile in shared memory by the softmax
//   scale (f32 product rounded to T, as K7 and the plain version do), then
//   per live key tile: S = Q K^T by wgmma (both operands K-major), the
//   epilogue in registers (softcap, ALiBi, the mask on boundary tiles only,
//   exp2(S log2 e - LSE log2 e), the dropout sign), the tile staged into
//   shared memory in TMA's 128-byte swizzle (so the accumulator rows hit
//   distinct banks) and written by one thread's asynchronous TMA stores
//   (two 32-column boxes of a rank-3 map over (sk, sq, b * h): rows and keys
//   past the plane are clipped). The staging is double-buffered: tile j's
//   store runs under tile j + 1's product and epilogue.
// - Dropout takes one Philox call per 4 adjacent columns of a row: the two
//   lanes that hold a 4-column group each compute the words of one of their
//   two rows and swap the keep bits by one __shfl_xor per tile.
// - Dead tiles (no visible entry: causal / window geometry, the tile tables
//   of explicit positions and segment ids) take no load and no product: the
//   same block writes their zeros with 16-byte stores (single floats when
//   sk % 4 != 0), taking them from a counter in shared memory: the producer
//   warp's 31 idle lanes from the start, beside the live tiles' products,
//   and the consumer warps once their live tiles are done. (Measured on the
//   card: TMA stores of a zeroed box, zeros interleaved one behind each live
//   tile, or all of them after the live tiles, were slower.)
// - Head dims: instantiated at the rungs D = 64, 128, 192 and 256 (the
//   library built with XFA_WIDE holds 192 and 256), serving any d up to 256
//   with the smallest rung D >= d, as K7: the tensor maps take the real d as
//   their inner extent, so TMA fills the tile's columns from d to D with
//   zeros, which add nothing to S. Rows must be 16-byte multiples (d % 8 ==
//   0; ops/flash_fwd.py pads other widths with a copy). At D = 256 the block
//   holds Q (32 KB), two K stages (64 KB) and the output boxes (32 KB).
// - sk % 4 != 0 breaks TMA's 16-byte row stride: the kTmaStore = false
//   instantiation copies the same staged tile out itself, 16 bytes a store
//   from each row's first aligned key on, single floats around them.
#include <type_traits>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;
using namespace hopper;

constexpr int kBQ = 64;     // query rows per block: one consumer warpgroup
constexpr int kBK = 64;     // keys per tile (= kTile of the tile tables)
constexpr int kThreadsProbs = 128 + 32;  // the consumer warpgroup and the producer warp
constexpr int kBoxCols = 32;             // f32 columns of one 128-byte swizzled store box
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kBK == kTile, "the tile tables are per 64 keys");

__device__ __forceinline__ float as_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float as_float(__half x) { return __half2float(x); }

// Shared memory of one block, from a 1024-byte aligned base: the Q tile as
// D / 64 sub-tiles of (kBQ rows x 64 columns), the K ring (per stage D / 64
// sub-tiles of kBK x 64), two staging buffers of one output tile each (two
// boxes of kBQ rows x 32 f32 columns), the barriers, then the counter of
// the key tiles taken by the threads that write dead tiles. At d = 128 the
// ring has one stage, so that three blocks fit an SM: the next K tile loads
// under this tile's epilogue.
template <int D>
struct Layout {
  static constexpr int kSub = D / 64;
  static constexpr int kStages = D == 128 ? 1 : 2;
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKBytes = kBK * D * 2;
  static constexpr int kBoxBytes = kBQ * kBoxCols * 4;
  static constexpr int kOutBytes = 2 * kBoxBytes;
  static constexpr int kKOffset = kQBytes;
  static constexpr int kOutOffset = kKOffset + kStages * kKBytes;
  static constexpr int kBarOffset = kOutOffset + 2 * kOutBytes;
  static constexpr int kCounterOffset = kBarOffset + 8 * (1 + 2 * kStages);
  static constexpr int kBytes = kCounterOffset + 4 + 1024;  // + alignment slack
};

struct ProbsParams {
  const float* lse;  // (b, h, sq)
  float* out;        // (b, h, sq, sk): the element stores of kTmaStore = false
  const int32_t* qseg;
  const int32_t* kseg;
  int b, h, h_k, sq, sk, wl, wr, n_qt;
  float softcap, scale;
};

// Whether any (row, key) of the tile pair can be visible: the index geometry
// without explicit positions, and the tile tables.
__device__ __forceinline__ bool tile_live(const Mask& m, const XfaExtras& ex, int ib, int q0,
                                          int k0) {
  if (k0 >= m.kv_len) return false;
  if (m.qpos == nullptr) {
    int lo, hi;
    m.key_range(q0, min(q0 + kBQ, m.sq), lo, hi);
    if (k0 + kBK <= lo || k0 >= hi) return false;
  }
  return tiles_meet(ex, m, ib, q0, k0);
}

// Byte offset of element (row r, column c) of a staged (kBQ x kBK) f32 tile:
// box c / 32, then TMA's 128-byte swizzle (16-byte chunk k of row r at k ^
// (r % 8)).
__device__ __forceinline__ int staged_offset(int r, int c) {
  const int cb = c % kBoxCols;
  return (c / kBoxCols) * (kBQ * kBoxCols * 4) + r * 128 + (((cb >> 2) ^ (r & 7)) << 4) +
         (cb & 3) * 4;
}

template <typename T, int D, bool kTmaStore>
__global__ void __launch_bounds__(kThreadsProbs, 3)
    flash_probs_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_out, const ProbsParams p,
                       const XfaExtras ex) {
  using L = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + L::kStages;
  auto k_tile = [&](int st) { return smem + L::kKOffset + st * L::kKBytes; };
  int* dead_next = reinterpret_cast<int*>(smem + L::kCounterOffset);

  // heaviest first: the last q tiles of every (batch, head) launch first
  const int nbh = p.b * p.h;
  const int iq = p.n_qt - 1 - static_cast<int>(blockIdx.x) / nbh;
  const int ih = static_cast<int>(blockIdx.x) % nbh % p.h;
  const int ib = static_cast<int>(blockIdx.x) % nbh / p.h;
  const int ihk = ih / (p.h / p.h_k);
  const int bh = ib * p.h + ih;
  const int q0 = iq * kBQ;
  const Mask mask = make_mask(ib, p.sq, p.sk, p.wl, p.wr, nullptr, p.qseg, p.kseg, ex);
  float* out_bh = p.out + static_cast<size_t>(bh) * p.sq * p.sk;

  // n threads of one warp (`members`, `leader` among them; this one the
  // idx-th) take key tiles from the block's counter and write the zeros of
  // the dead ones until none is left: 16 bytes a store when sk % 4 == 0.
  auto write_dead = [&](unsigned members, int leader, int idx, int n) {
    for (;;) {
      int kt = 0;
      if ((threadIdx.x & 31) == leader) kt = atomicAdd(dead_next, 1);
      const int k0 = __shfl_sync(members, kt, leader) * kBK;
      if (k0 >= p.sk) return;
      if (tile_live(mask, ex, ib, q0, k0)) continue;
      if constexpr (kTmaStore) {
        for (int i = idx; i < kBQ * kBK / 4; i += n) {
          const int qi = q0 + i / (kBK / 4), kj = k0 + (i % (kBK / 4)) * 4;
          if (qi < p.sq && kj < p.sk)
            *reinterpret_cast<float4*>(out_bh + static_cast<size_t>(qi) * p.sk + kj) =
                make_float4(0.f, 0.f, 0.f, 0.f);
        }
      } else {
        for (int i = idx; i < kBQ * kBK; i += n) {
          const int qi = q0 + i / kBK, kj = k0 + i % kBK;
          if (qi < p.sq && kj < p.sk) out_bh[static_cast<size_t>(qi) * p.sk + kj] = 0.f;
        }
      }
    }
  };

  if (threadIdx.x == 0) {
    *dead_next = 0;
    mbar_init(q_full, 1);
    for (int st = 0; st < L::kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 1);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // the producer warp
    if (threadIdx.x == 128) {  // lane 0 issues the loads
      mbar_arrive_expect_tx(q_full, L::kQBytes);
#pragma unroll
      for (int s = 0; s < L::kSub; ++s)
        tma_load_4d(smem + s * kBQ * 128, &tm_q, q_full, s * 64, q0, ih, ib);
      int it = 0;
      for (int k0 = 0; k0 < p.sk; k0 += kBK) {
        if (!tile_live(mask, ex, ib, q0, k0)) continue;
        const int st = it % L::kStages;
        const uint32_t phase = (it / L::kStages) & 1;
        ++it;
        mbar_wait(&empty[st], phase ^ 1);
        mbar_arrive_expect_tx(&full[st], L::kKBytes);
#pragma unroll
        for (int s = 0; s < L::kSub; ++s)
          tma_load_4d(k_tile(st) + s * kBK * 128, &tm_k, &full[st], s * 64, k0, ihk, ib);
      }
    } else {  // the other 31 lanes: dead tiles from the start
      write_dead(0xFFFFFFFEu, 1, (threadIdx.x & 31) - 1, 31);
    }
    return;
  }

  // ---- the consumer warpgroup ----
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int rl = warp * 16 + (lane >> 2);  // this thread's rows of the tile: rl, rl + 8
  const int row = q0 + rl;
  const int col = (lane & 3) * 2;  // and col + 1, in every 8-column group

  // this thread's two rows: LSE, ALiBi slope, position and segment id, read
  // once (mask.keep and mask.dist would read them for every entry)
  float lse_l2[2], slope[2], qposf[2];
  int qpos[2], qseg[2];
  bool live_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row + 8 * r;
    const float x = qi < p.sq ? p.lse[static_cast<size_t>(bh) * p.sq + qi] : -INFINITY;
    live_r[r] = x > -3e38f;  // false past sq
    lse_l2[r] = live_r[r] ? x * kLog2e : 0.f;
    slope[r] = alibi_slope(ex, ib, ih, p.h, p.sq, qi);
    qpos[r] = mask.qp(qi);
    qposf[r] = static_cast<float>(qpos[r]);
    qseg[r] = mask.qseg != nullptr ? mask.qseg[min(qi, p.sq - 1)] : 0;
  }
  const bool alibi = ex.alibi != nullptr || ex.row_slopes != nullptr;

  // The staged tile `buf` to the plane without TMA (sk % 4 != 0): a
  // half-warp takes a row, 16-byte stores from the row's first 16-byte
  // aligned key on, single floats before it and after the last whole 4.
  auto store_rows = [&](int k0, const unsigned char* buf) {
    const int n = min(kBK, p.sk - k0);
    const int hl = lane & 15;
    auto at = [&](int r, int c) {
      return *reinterpret_cast<const float*>(buf + staged_offset(r, c));
    };
    for (int r = 2 * warp + (lane >> 4); r < kBQ && q0 + r < p.sq; r += 8) {
      float* dst = out_bh + static_cast<size_t>(q0 + r) * p.sk + k0;
      const int align = static_cast<int>((reinterpret_cast<uintptr_t>(dst) >> 2) & 3);
      const int head = min(n, (4 - align) & 3);
      const int body = (n - head) / 4, tail = head + 4 * body;
      if (hl < head) dst[hl] = at(r, hl);
      if (hl < body) {
        const int c = head + 4 * hl;
        *reinterpret_cast<float4*>(dst + c) = make_float4(at(r, c), at(r, c + 1), at(r, c + 2),
                                                          at(r, c + 3));
      }
      if (hl < n - tail) dst[tail + hl] = at(r, tail + hl);
    }
  };

  float s[kBK / 2];  // S, then P, of one key tile: 8-column group j holds s[4j .. 4j+3]
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) s[i] = 0.f;
  int it = 0, n_stored = 0;
  for (int k0 = 0; k0 < p.sk; k0 += kBK) {
    if (!tile_live(mask, ex, ib, q0, k0)) continue;
    if (it == 0) {  // the softmax scale, in f32 and rounded to T, on the Q tile
      mbar_wait(q_full, 0);
#pragma unroll
      for (int sub = 0; sub < L::kSub; ++sub) {
        uint4* base = reinterpret_cast<uint4*>(smem + sub * kBQ * 128);
        for (int i = tid; i < kBQ * 8; i += 128) {
          uint4 w = base[i];
          T* e = reinterpret_cast<T*>(&w);
#pragma unroll
          for (int j = 0; j < 8; ++j) e[j] = Mma<T>::from_float(as_float(e[j]) * p.scale);
          base[i] = w;
        }
      }
      fence_proxy_async();  // before wgmma reads it
      named_barrier_sync(1, 128);
    }
    const int st = it % L::kStages;
    const uint32_t phase = (it / L::kStages) & 1;
    ++it;
    mbar_wait(&full[st], phase);
    // S = Q K^T
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t da = desc_sw128(smem + (kk / 4) * kBQ * 128 + (kk % 4) * 32, 16, 1024);
      const uint64_t db = desc_sw128(k_tile(st) + (kk / 4) * kBK * 128 + (kk % 4) * 32, 16, 1024);
      Wgmma<T, kBK>::ss(s, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    if (tid == 0) mbar_arrive(&empty[st]);  // the warpgroup is done with the K stage

    // softcap, ALiBi, the mask on boundary tiles, P = exp(S - LSE)
    if (p.softcap > 0.f) {
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) s[i] = tanhf(s[i] / p.softcap) * p.softcap;
    }
    if (alibi) {
      if (mask.kpos == nullptr) {  // key j at j: exact in float below 2^24
        const float kb = static_cast<float>(k0 + col);
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i)
          s[i] -= slope[(i >> 1) & 1] *
                  fabsf(qposf[(i >> 1) & 1] - (kb + static_cast<float>((i >> 2) * 8 + (i & 1))));
      } else {  // each column's position read once for both rows
#pragma unroll
        for (int c = 0; c < kBK / 4; ++c) {
          const float kp = static_cast<float>(mask.kp(k0 + (c >> 1) * 8 + col + (c & 1)));
#pragma unroll
          for (int r = 0; r < 2; ++r)
            s[4 * (c >> 1) + 2 * r + (c & 1)] -= slope[r] * fabsf(qposf[r] - kp);
        }
      }
    }
    uint32_t visible = 0;  // bit i: entry s[i] is visible
    if (tile_interior<true>(mask, ex, ib, q0, k0)) {
      visible = (live_r[0] ? 0x33333333u : 0u) | (live_r[1] ? 0xCCCCCCCCu : 0u);
    } else {  // mask.keep, each column's position and segment id read once
#pragma unroll
      for (int c = 0; c < kBK / 4; ++c) {
        const int kj = k0 + (c >> 1) * 8 + col + (c & 1);
        const int kp = mask.kp(kj);
        const int ks = mask.kseg != nullptr ? mask.kseg[min(kj, p.sk - 1)] : 0;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const bool vis = live_r[r] && kj < mask.kv_len &&
                           (mask.wr < 0 || kp <= qpos[r] + mask.wr) &&
                           (mask.wl < 0 || kp >= qpos[r] - mask.wl) && ks == qseg[r];
          visible |= static_cast<uint32_t>(vis) << (4 * (c >> 1) + 2 * r + (c & 1));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i)
      s[i] = (visible >> i) & 1u ? exp2f(fmaf(s[i], kLog2e, -lse_l2[(i >> 1) & 1])) : 0.f;
    // dropout: lanes 2m and 2m + 1 hold the 4-column group (k0 + 8j + 4 (m & 1)
    // .. + 3) of rows row and row + 8; the even lane draws the words of row,
    // the odd lane those of row + 8, one Philox call per group each, and the
    // two swap the keep bits
    if (ex.drop_thresh != 0) {
      const bool odd = lane & 1;
      const uint32_t c4 = static_cast<uint32_t>(k0 >> 2) + ((lane & 3) >> 1);
      const uint32_t drow = static_cast<uint32_t>(odd ? row + 8 : row);
      uint32_t mine = 0;  // bits 4j .. 4j+3: keep bits of group j's four columns
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const uint4 w = philox4x32_10(
            make_uint4(c4 + 2 * j, drow, static_cast<uint32_t>(ih), static_cast<uint32_t>(ib)),
            static_cast<uint32_t>(ex.seed), static_cast<uint32_t>(ex.seed >> 32));
        mine |= (static_cast<uint32_t>(w.x >= ex.drop_thresh) |
                 static_cast<uint32_t>(w.y >= ex.drop_thresh) << 1 |
                 static_cast<uint32_t>(w.z >= ex.drop_thresh) << 2 |
                 static_cast<uint32_t>(w.w >= ex.drop_thresh) << 3)
                << (4 * j);
      }
      const uint32_t other = __shfl_xor_sync(0xFFFFFFFFu, mine, 1);
      const uint32_t bits[2] = {odd ? other : mine, odd ? mine : other};
      const int sh = odd ? 2 : 0;  // this lane's two columns of the group
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const bool keep = (bits[(i >> 1) & 1] >> (4 * (i >> 2) + sh + (i & 1))) & 1u;
        // only visible entries carry the sign: masked ones stay +0
        if (!keep && ((visible >> i) & 1u)) s[i] = -s[i];
      }
    }

    // stage the tile into the buffer that the store before last has read
    unsigned char* buf = smem + L::kOutOffset + (n_stored & 1) * L::kOutBytes;
    ++n_stored;
    if constexpr (kTmaStore) {
      if (tid == 0) bulk_wait_read<1>();
      named_barrier_sync(2, 128);
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(buf + staged_offset(rl + 8 * r, 8 * j + col)) =
            make_float2(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]);
    }
    if constexpr (kTmaStore) {
      fence_proxy_async();
      named_barrier_sync(1, 128);
      if (tid == 0) {
        tma_store_3d(&tm_out, buf, k0, q0, bh);
        tma_store_3d(&tm_out, buf + L::kBoxBytes, k0 + kBoxCols, q0, bh);
        bulk_commit();
      }
    } else {
      named_barrier_sync(1, 128);
      store_rows(k0, buf);
    }
  }
  // the dead tiles that the producer warp has not taken yet
  write_dead(0xFFFFFFFFu, 0, lane, 32);
  if constexpr (kTmaStore) {
    if (tid == 0) bulk_wait<0>();  // the stores have read the block's shared memory
  }
}

template <typename T, int D, bool kTmaStore>
cudaError_t launch_kernel(const CUtensorMap (&maps)[3], const ProbsParams& prm,
                          const XfaExtras& ex, cudaStream_t stream) {
  using L = Layout<D>;
  auto* kernel = &flash_probs_kernel<T, D, kTmaStore>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>(prm.n_qt) * prm.h * prm.b;
  kernel<<<grid, kThreadsProbs, L::kBytes, stream>>>(maps[0], maps[1], maps[2], prm, ex);
  return cudaGetLastError();
}

// strides: q and k, each (batch, head, row) in elements
template <typename T, int D>
cudaError_t launch(int d, const void* q, const void* k, const int64_t* strides, ProbsParams prm,
                   const XfaExtras& ex, cudaStream_t stream) {
  const bool f16 = std::is_same<T, __half>::value;
  CUtensorMap maps[3] = {};
  const void* bases[2] = {q, k};
  const int rows[2] = {prm.sq, prm.sk};
  const int heads[2] = {prm.h, prm.h_k};
  const uint32_t box_rows[2] = {kBQ, kBK};
  for (int i = 0; i < 2; ++i) {
    const int64_t* st = strides + 3 * i;
    const uint64_t dims[4] = {static_cast<uint64_t>(d), static_cast<uint64_t>(rows[i]),
                              static_cast<uint64_t>(heads[i]), static_cast<uint64_t>(prm.b)};
    const uint64_t bytes[3] = {static_cast<uint64_t>(st[2]) * 2, static_cast<uint64_t>(st[1]) * 2,
                               static_cast<uint64_t>(st[0]) * 2};
    cudaError_t err = make_map_4d(&maps[i], f16, bases[i], dims, bytes, 64, box_rows[i]);
    if (err != cudaSuccess) return err;
  }
  prm.n_qt = (prm.sq + kBQ - 1) / kBQ;
  // TMA stores need 16-byte row strides and base
  if (prm.sk % 4 != 0 || reinterpret_cast<uintptr_t>(prm.out) % 16 != 0)
    return launch_kernel<T, D, false>(maps, prm, ex, stream);
  const uint64_t dims[3] = {static_cast<uint64_t>(prm.sk), static_cast<uint64_t>(prm.sq),
                            static_cast<uint64_t>(prm.b) * prm.h};
  const uint64_t bytes[2] = {static_cast<uint64_t>(prm.sk) * 4,
                             static_cast<uint64_t>(prm.sk) * prm.sq * 4};
  const uint32_t box[3] = {kBoxCols, kBQ, 1};
  cudaError_t err = make_map(&maps[2], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, prm.out, dims, bytes,
                             box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  return launch_kernel<T, D, true>(maps, prm, ex, stream);
}

#ifdef XFA_WIDE
constexpr int kRungLo = 192, kRungHi = 256;
#else
constexpr int kRungLo = 64, kRungHi = 128;
#endif

// The instantiation at d's rung (the smallest of this library's two >= d).
template <typename T>
cudaError_t launch_d(int d, const void* q, const void* k, const int64_t* strides,
                     const ProbsParams& prm, const XfaExtras& ex, cudaStream_t stream) {
  const int rung = (d + 63) / 64 * 64;
  if (rung == kRungHi) return launch<T, kRungHi>(d, q, k, strides, prm, ex, stream);
  if (rung == kRungLo) return launch<T, kRungLo>(d, q, k, strides, prm, ex, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (b, h, sq, d), k (b, h_k, sk, d) bf16 (XFA_BF16) or fp16 (XFA_F16), d a
// multiple of 8 at this library's rungs (64 and 128, or with XFA_WIDE 192
// and 256: up to 256), each with its last dimension contiguous and its (batch, head, row)
// strides in elements at strides[0..2] (q) and [3..5] (k): multiples of 8,
// bases 16-byte aligned (the tensor maps' rule). q is not pre-scaled: the
// kernel multiplies it by `scale`. lse (b, h, sq) f32 contiguous, from the
// forward with the same options. Writes out (b, h, sq, sk) f32 contiguous.
// q_seg (b, sq) and kv_seg (b, sk) int32 may be null; wl / wr the window
// (< 0 unbounded); extras as for xfa_flash_fwd, in host memory.
extern "C" int xfa_flash_probs(const void* q, const void* k, const void* lse, void* out,
                               const void* q_seg, const void* kv_seg, int dtype, int b, int h,
                               int h_k, int sq, int sk, int d, int wl, int wr, float softcap,
                               float scale, const int64_t* strides,
                               const flash::XfaExtras* extras, void* stream) {
  if (h_k <= 0 || h % h_k != 0 || extras == nullptr || strides == nullptr || d < 1 || d > 256 ||
      d % 8)
    return cudaErrorInvalidValue;
  if ((q_seg == nullptr) != (kv_seg == nullptr)) return cudaErrorInvalidValue;
  if ((extras->qpos == nullptr) != (extras->kpos == nullptr)) return cudaErrorInvalidValue;
  if ((extras->qtiles == nullptr) != (extras->ktiles == nullptr)) return cudaErrorInvalidValue;
  if (b == 0 || h == 0 || sq == 0 || sk == 0) return cudaSuccess;
  ProbsParams prm{};
  prm.lse = static_cast<const float*>(lse);
  prm.out = static_cast<float*>(out);
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
      return launch_d<__nv_bfloat16>(d, q, k, strides, prm, *extras, st);
    case XFA_F16:
      return launch_d<__half>(d, q, k, strides, prm, *extras, st);
    default:
      return cudaErrorInvalidValue;
  }
}
