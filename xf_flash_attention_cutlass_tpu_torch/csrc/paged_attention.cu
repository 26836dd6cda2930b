// Paged split-KV attention over a block-table KV pool (K1).
//
// Replaces the TPU kernel xf_flash_attention_cutlass_tpu/ops/paged.py
// `_paged_kernel` (:97, launched at :745): attention of new query tokens over
// the pages of a block table, causal from the bottom right (query token t of
// sq sits at position kv_len - sq + t), int8 / fp8-e4m3 / bf16 pools with the
// per-token K scale on the score plane and the V scale on P, split-KV f32
// partials (O, LSE) with LSE = -inf for rows that saw no key, merged by
// `paged_combine_kernel` (the decode and Hopper chunk routes) or by
// combine_partials in plain torch (the WMMA route), as on the TPU.
//
// Bound on an H100 (3.35 TB/s, 989 TFLOP/s bf16): decode (sq = 1, b = 8,
// Llama-8B GQA 32/8 heads, d = 128, fp8 pools) reads each live key and
// value byte once and does 4 * group = 16 flops per K/V byte pair, far
// below the ~295 flops per byte the card needs to be compute bound: bytes
// bound. A 256-token prefill chunk does 4 * 256 * group flops per key:
// operations bound (tensor cores).
//
// Four kernels, chosen by ops/paged.py::paged_route (a pure function of the
// shapes and the query and pool dtypes; the options choose an
// instantiation, not a kernel). The first three take bf16 or fp16 queries
// (a template parameter T: one instantiation each, over pools of T, int8 or
// fp8; fp16 has bf16's product shapes and bytes, every int8 and e4m3 value
// is an fp16 value too, and P is rounded to T before the PV product); the
// comments below say bf16 for T. The fourth, `paged_f32_kernel`, takes f32
// queries over f32, int8 or fp8 pools.
//
// `paged_decode_kernel` (the decode route: at most 16 query rows a KV head,
// sq * group: decode and short verify; pages of a multiple of 8 keys,
// bf16 / int8 / fp8 pools). Decode is bound by bytes and by latency: a step reads
// each live K/V byte once for 4 * group flops, and the work of one call is a
// few MB, so the design keeps many bytes in flight and few passes around
// them. One block owns one (split, batch entry, KV head): all of the GQA
// group's rows, so each K/V byte is read once for the group. Each entry's
// live keys are cut into n_splits runs of whole 64-key tiles (not pages),
// so short contexts still fill the card; splits past the live tiles write
// an empty partial. A producer warp streams the split's tiles into an
// mbarrier ring as raw pool bytes (TMA boxes, one per page run of a
// tile, swizzled; the scales of the run by bulk copy beside them), as many
// stages as leave exactly two blocks an SM. Four
// consumer warps each take 16 keys of every tile with mma.sync m16n8k16:
// S^T = K Q^T (the keys as M, the rows as N = 8 or 16; K by ldmatrix and
// converted to bf16 in registers, exact for int8 and e4m3; Q times the
// softmax scale in registers), the K scale, the mask on boundary tiles, an
// exp2 online softmax per warp, P times the V scale rounded to bf16 and
// moved to B fragments by movmatrix, O^T += V^T P^T (V by ldmatrix .trans,
// its keys past kv_len zeroed in registers). No block-wide barrier per
// tile: the warps' (m, l, O) are merged once at the end through shared
// memory, and O (b, sq, h, d) bf16 and LSE (b, h, sq), or f32 partials in
// that layout, are written in the caller's layout. `paged_combine_kernel`
// merges partials (one warp per row) into O bf16 and LSE (b, h, sq).
//
// `paged_wgmma_kernel` (the Hopper route: more than 16 query rows a KV head,
// the same d, pages and pools). One block owns one
// (split, batch entry, KV head, 64-row tile) of the rows t * group + g
// (token-major, the GQA group inside), so at Llama-8B's group of 4 the 16
// tokens' 64 rows share every K/V tile fetched; blocks launch heaviest first
// (the last row tiles see the most keys). A producer warpgroup walks the
// split's live 64-key tiles, reading each key's page from the block table,
// and fills a 2-stage ring of bf16 K/V tiles, 128-byte swizzled for wgmma:
// bf16 pools by TMA straight into the ring, one box per page run of the tile;
// int8 / fp8 pools by TMA byte boxes into a 2-stage staging ring that the
// warpgroup converts to bf16 into the ring (exact for int8 and e4m3), with
// the tile's 64 K and V scales beside it. The tensor maps span every layer's
// pages, so `layer_idx` is a page coordinate. Keys past the split, kv_len or
// the causal limit are never loaded (rows of a tile past them are zero). One
// consumer warpgroup writes the 64 rows' Q into shared memory, multiplied by
// the softmax scale inside the kernel (f32 product rounded to bf16), and per
// tile runs S = Q K^T (wgmma, both operands K-major in shared memory), the K scale
// per column, the mask on boundary tiles only (the diagonal, the split and
// kv_len edges), the online softmax in registers with exp2, P times the V
// scale rounded to bf16, and O += P V (wgmma, P from registers, V MN-major
// from the ring, so V is never transposed). With one split it writes O in
// the caller's (b, sq, h, d) bf16 layout and LSE (b, h, sq); with more, f32
// partials (splits, b, sq, h, d) and (splits, b, sq, h) for the combine kernel.
// The producer hands its registers to the consumer (setmaxnreg); two blocks
// an SM, one for int8 / fp8 pools at d = 128 and at the rungs 192 and 256
// (shared memory).
//
// Head dims: every kernel takes any d from 1 to 256. It is instantiated at
// the rungs D = 64, 128, 192 and 256 and serves d with the smallest rung D >=
// d (by_rung); the Hopper kernels' tensor maps take the real d as their inner
// extent, so TMA zero-fills a tile's columns from d to D without reading
// them, the WMMA and f32 kernels skip those chunks, and only d columns of O
// are stored. Rows must be whole 16-byte chunks (head_dim_ok); the wrapper
// pads other widths with a copy (ops/paged.py::paged_attention_padded).
//
// Both Hopper kernels have a second instantiation, kExtra, for the options
// the API passes (the option-free one, which serving runs, compiles to the
// code it had before them): a window (wl, wr) from query position
// kv_len - sq + t, non-causal included; the tanh softcap on the K-scaled
// score; ALiBi, the score of row t * group + g losing slope[b, kv_head * group
// + g] * |qpos - kcol| after the softcap; and cache_leftpad, which masks the
// keys before it. For every key a row can see (kcol >= leftpad),
// |(qpos - leftpad) - (kcol - leftpad)| = |qpos - kcol|, so the leftpad takes
// no part in ALiBi and only masks. As the TPU kernel folds the window start
// into its loop bound, the split runs start at the unit (64-key tile on the
// decode route, page on the chunk route) of the first key any row can see
// (window start of the first row, leftpad; ops/paged.py::first_page), and a
// chunk block starts at its first row's earliest key rounded down to a TMA
// box (so no box crosses a page) and ends at its last row's right limit.
// Softcap and ALiBi act on every tile, in natural units before the exp2;
// the window start, the right window and the leftpad are masked on boundary
// tiles only, beside kv_len.
//
// `paged_f32_kernel` (the f32 route: f32 queries, any page): wgmma has no f32
// inputs and its tf32 mode keeps 10 mantissa bits, so this is a simple FMA
// kernel in f32 (about 67 TFLOP/s on an H100). One block owns 16 query rows
// of one (split, batch entry, KV head), the split a run of live pages as on
// the WMMA route; per 64-key tile K and V are converted to f32 into shared
// memory, S = Q K^T and O += P V run on the FMA units with an online softmax
// in between, the options (window, softcap, ALiBi, leftpad) are applied at
// run time, and O and LSE (or f32 partials for the combine kernel) are
// written in the caller's layout. Bound at decode by bytes (f32 pools: 1 KB
// of K and V a key and KV head at d = 128), at a 256-token chunk by
// operations.
//
// `paged_attention_kernel` (the first version on WMMA: pages of no whole
// TMA box, with or without the options, at any row count): one block per (row tile,
// batch entry, KV head, split), a row tile holding RT (16 or 32) query rows
// of ONE KV head, ordered token-major with the GQA group inside. Each batch
// entry's LIVE pages are cut into n_splits equal runs, so every split of a
// row has work whatever the table width. The block walks the keys of its
// split in tiles of 64: each key's page comes from the block table, the next
// tile's K, V and scales are loaded into registers while the current tile is
// computed (one tile of prefetch), K and V are converted to bf16 in shared
// memory (exact for int8 and e4m3), S = Q K^T and O += P V run on the tensor
// cores (WMMA, f32 accumulate), and an online softmax in f32 keeps the
// running max m, the sum l and the accumulator O in shared memory. As on the
// TPU the softmax scale is folded into q by the wrapper, and P is rounded to
// bf16 (q's dtype) after the V scale and before the PV product. Keys past the
// causal limit, the split or kv_len are never loaded. Rows with kv_len = 0
// (inactive slots) give O = 0 and LSE = -inf. Its kExtra instantiation takes
// the options as the Hopper ones do; the pages before the first key any row
// can see are left out of its split runs, and a block starts at its first
// row's earliest key.
#include <mma.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

using namespace nvcuda;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int TK = 64;  // keys per tile
// masked scores: far below any real score, and exp(NEG_INF - m) == 0 for
// the running-max floor M_FLOOR (as in the TPU kernel)
constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;
constexpr float M_FLOOR = -1e30f;

__host__ __device__ constexpr int align128(int x) { return (x + 127) / 128 * 128; }

// Head-dim rungs. Every kernel is instantiated at D = 64, 128, 192 and 256
// and serves a head dim d with the smallest rung D >= d
// (ops/paged.py::head_dim_rung): its tiles are D wide, the columns from d to
// D are zeros (TMA fills them, or the loads skip them), they add nothing to
// S and give O columns that are never stored. The library built with
// XFA_WIDE holds the rungs 192 and 256, the one without it 64 and 128, so
// that they compile in parallel (_build.VARIANTS).
#ifdef XFA_WIDE
constexpr int kRungLo = 192, kRungHi = 256;
#else
constexpr int kRungLo = 64, kRungHi = 128;
#endif

// Calls f(std::integral_constant<int, D>{}) with d's rung D, or returns
// cudaErrorInvalidValue when this library does not hold it.
template <typename F>
cudaError_t by_rung(int d, F&& f) {
  const int rung = (d + 63) / 64 * 64;
  if (d < 1 || (rung != kRungLo && rung != kRungHi)) return cudaErrorInvalidValue;
  return rung == kRungHi ? f(std::integral_constant<int, kRungHi>{})
                         : f(std::integral_constant<int, kRungLo>{});
}

template <int D, int RT>
struct Smem {
  static constexpr int LDQ = D + 8;   // bf16 rows of Q, K, V
  static constexpr int LDS = TK + 4;  // f32 score rows
  static constexpr int LDP = TK + 8;  // bf16 probability rows
  static constexpr int LDO = D + 4;   // f32 accumulator rows
  static constexpr int q = 0;
  static constexpr int k = q + align128(RT * LDQ * 2);
  static constexpr int v = k + align128(TK * LDQ * 2);
  static constexpr int s = v + align128(TK * LDQ * 2);
  static constexpr int p = s + align128(RT * LDS * 4);
  static constexpr int o = p + align128(RT * LDP * 2);
  static constexpr int stats = o + align128(RT * LDO * 4);  // m, l, corr: 3 * RT
  static constexpr int scales = stats + align128(3 * RT * 4);  // ks, vs: 2 * TK
  static constexpr int bytes = scales + align128(2 * TK * 4);
};

template <typename T, typename KV>
__device__ __forceinline__ void store_row16(T* dst, const uint4& raw) {
  // 16 bytes of KV values -> 16 / sizeof(KV) T values at dst (exact: KV is T,
  // int8 or e4m3)
  constexpr int E = 16 / sizeof(KV);
  const KV* v = reinterpret_cast<const KV*>(&raw);
#pragma unroll
  for (int e = 0; e < E; ++e) dst[e] = from_float<T>(to_float(v[e]));
}

// One key tile of a block in registers: each thread's 16-byte chunks of the
// K and V rows, and (threads < TK) one key's two scales.
template <typename KV, int D>
struct TileRegs {
  static constexpr int CH = 16 / sizeof(KV);  // values per 16-byte chunk
  static constexpr int LOADS = TK * (D / CH) / kThreads;
  static_assert(TK * (D / CH) % kThreads == 0, "tile chunks must split evenly");
  uint4 k[LOADS], v[LOADS];
  float ks, vs;

  // the zero byte is 0 in every KV dtype, so keys past kend load as zeros
  // (rows of d values, d <= D and a multiple of CH: chunks past d load as zeros)
  __device__ __forceinline__ void load(const KV* k_pool, const KV* v_pool, const float* k_scales,
                                       const float* v_scales, const int32_t* bt_row, int k0,
                                       int kend, int kvh, int h_k, int page, int d) {
    const size_t head_stride = static_cast<size_t>(page) * d;
#pragma unroll
    for (int it = 0; it < LOADS; ++it) {
      const int c = threadIdx.x + it * kThreads;
      const int kp = k0 + c / (D / CH), dc = (c % (D / CH)) * CH;
      k[it] = v[it] = make_uint4(0, 0, 0, 0);
      if (kp < kend && dc < d) {
        const size_t off = (static_cast<size_t>(bt_row[kp / page]) * h_k + kvh) * head_stride +
                           static_cast<size_t>(kp % page) * d + dc;
        k[it] = *reinterpret_cast<const uint4*>(k_pool + off);
        v[it] = *reinterpret_cast<const uint4*>(v_pool + off);
      }
    }
    const int kp = k0 + threadIdx.x;
    ks = 1.f;
    vs = 0.f;  // P of a key past kend is 0 whatever its score
    if (threadIdx.x < TK && kp < kend) {
      vs = 1.f;
      if (k_scales != nullptr) {
        const size_t so = (static_cast<size_t>(bt_row[kp / page]) * h_k + kvh) * page + kp % page;
        ks = k_scales[so];
        vs = v_scales[so];
      }
    }
  }

  template <typename T>
  __device__ __forceinline__ void store(T* ks_smem, T* vs_smem, float* ksc, float* vsc,
                                        int ldq) const {
#pragma unroll
    for (int it = 0; it < LOADS; ++it) {
      const int c = threadIdx.x + it * kThreads;
      const int j = c / (D / CH), dc = (c % (D / CH)) * CH;
      store_row16<T, KV>(ks_smem + j * ldq + dc, k[it]);
      store_row16<T, KV>(vs_smem + j * ldq + dc, v[it]);
    }
    if (threadIdx.x < TK) {
      ksc[threadIdx.x] = ks;
      vsc[threadIdx.x] = vs;
    }
  }
};

template <typename T, typename KV, int D, int RT, bool kExtra>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q,              // (b, sq, h, d), pre-scaled
    const KV* __restrict__ k_pool,        // (pages, h_k, page, d): one layer
    const KV* __restrict__ v_pool,
    const float* __restrict__ k_scales,  // (pages, h_k, page) or null
    const float* __restrict__ v_scales,
    const int32_t* __restrict__ block_tables,  // (b, max_pages)
    const int32_t* __restrict__ kv_lens,       // (b,)
    float* __restrict__ o_part,                // (splits, b, h_k, R, d)
    float* __restrict__ lse_part,              // (splits, b, h_k, R)
    const float* __restrict__ alibi,           // (b, h) or null
    const int32_t* __restrict__ leftpad,       // (b,) or null
    int b, int sq, int h_k, int group, int page, int max_pages, int wl, int wr,
    float softcap, int d) {
  using L = Smem<D, RT>;
  constexpr int LDQ = L::LDQ, LDS = L::LDS, LDP = L::LDP, LDO = L::LDO;

  extern __shared__ __align__(128) unsigned char smem[];
  auto* qs = reinterpret_cast<T*>(smem + L::q);
  auto* ks = reinterpret_cast<T*>(smem + L::k);
  auto* vs = reinterpret_cast<T*>(smem + L::v);
  auto* ss = reinterpret_cast<float*>(smem + L::s);
  auto* ps = reinterpret_cast<T*>(smem + L::p);
  auto* os = reinterpret_cast<float*>(smem + L::o);
  auto* m_s = reinterpret_cast<float*>(smem + L::stats);
  auto* l_s = m_s + RT;
  auto* c_s = l_s + RT;
  auto* ksc = reinterpret_cast<float*>(smem + L::scales);
  auto* vsc = ksc + TK;

  const int R = group * sq;  // query rows of one KV head
  const int r0 = blockIdx.x * RT;
  const int ib = blockIdx.y / h_k, kvh = blockIdx.y % h_k;
  const int split = blockIdx.z;
  const int h = h_k * group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const int kv_len = kv_lens[ib];
  const int n_live = min((kv_len + page - 1) / page, max_pages);
  int lp = 0, first_page = 0;  // leftpad; the first page any row can see
  if constexpr (kExtra) {
    lp = leftpad != nullptr ? max(0, leftpad[ib]) : 0;
    const int first_key = wl >= 0 ? max(lp, kv_len - sq - wl) : lp;
    first_page = min(max(first_key, 0) / page, n_live);
  }
  const int pages_per_split = (n_live - first_page + gridDim.z - 1) / gridDim.z;
  const int lo = first_page + split * pages_per_split;
  const int hi = min(lo + pages_per_split, n_live);
  int kstart = lo * page;
  if constexpr (kExtra) {  // the tile's first row sees no key before these
    const int t_first = min(r0 / group, sq - 1);
    kstart = max(kstart, wl >= 0 ? max(lp, kv_len - sq + t_first - wl) : lp);
  }
  int kend = min(hi * page, kv_len);
  if (wr >= 0) {  // the tile's last row sees no key past its position + wr
    const int t_last = min((min(r0 + RT, R) - 1) / group, sq - 1);
    kend = min(kend, kv_len - sq + t_last + 1 + wr);
  }

  // Q tile (zeros past the last real row and past d), stats and accumulator
  for (int c = threadIdx.x; c < RT * (D / 8); c += kThreads) {
    const int r = c / (D / 8), dc = (c % (D / 8)) * 8;
    const int gr = r0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (gr < R && dc < d) {
      const int t = gr / group, gi = gr % group;
      val = *reinterpret_cast<const uint4*>(
          q + ((static_cast<size_t>(ib) * sq + t) * h + kvh * group + gi) * d + dc);
    }
    *reinterpret_cast<uint4*>(qs + r * LDQ + dc) = val;
  }
  for (int i = threadIdx.x; i < RT * LDO; i += kThreads) os[i] = 0.f;
  for (int i = threadIdx.x; i < RT; i += kThreads) {
    m_s[i] = M_FLOOR;
    l_s[i] = 0.f;
  }

  const int32_t* bt_row = block_tables + static_cast<size_t>(ib) * max_pages;
  TileRegs<KV, D> regs;
  if (kstart < kend)
    regs.load(k_pool, v_pool, k_scales, v_scales, bt_row, kstart, kend, kvh, h_k, page, d);
  for (int k0 = kstart; k0 < kend; k0 += TK) {
    __syncthreads();  // previous tile fully consumed
    regs.store(ks, vs, ksc, vsc, LDQ);
    __syncthreads();
    if (k0 + TK < kend)  // in flight while this tile is computed
      regs.load(k_pool, v_pool, k_scales, v_scales, bt_row, k0 + TK, kend, kvh, h_k, page, d);

    // S = Q K^T on the tensor cores
    for (int f = warp; f < (RT / 16) * (TK / 16); f += kWarps) {
      const int fi = f / (TK / 16), fj = f % (TK / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> bk;
        wmma::load_matrix_sync(a, qs + fi * 16 * LDQ + kk, LDQ);
        wmma::load_matrix_sync(bk, ks + fj * 16 * LDQ + kk, LDQ);
        wmma::mma_sync(acc, a, bk, acc);
      }
      wmma::store_matrix_sync(ss + fi * 16 * LDS + fj * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncthreads();

    // online softmax, one warp per row, two columns per lane
    for (int r = warp; r < RT; r += kWarps) {
      const int t = min((r0 + r) / group, sq - 1);
      const int qpos = kv_len - sq + t;
      float slope = 0.f;
      if constexpr (kExtra) {
        if (alibi != nullptr) slope = alibi[ib * h_k * group + kvh * group + (r0 + r) % group];
      }
      float sv[TK / 32];
      float rmax = NEG_INF;
#pragma unroll
      for (int u = 0; u < TK / 32; ++u) {
        const int c = lane + 32 * u;
        const int kcol = k0 + c;
        bool keep = kcol < kend && (wr < 0 || kcol <= qpos + wr);
        float x = ss[r * LDS + c] * ksc[c];
        if constexpr (kExtra) {
          keep = keep && (wl < 0 || kcol >= qpos - wl) && kcol >= lp;
          if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
          x -= slope * fabsf(static_cast<float>(qpos - kcol));  // no leftpad term
        }
        sv[u] = keep ? x : NEG_INF;
        rmax = fmaxf(rmax, sv[u]);
      }
      for (int o = 16; o > 0; o >>= 1) rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, rmax);
      float rsum = 0.f;
#pragma unroll
      for (int u = 0; u < TK / 32; ++u) {
        const int c = lane + 32 * u;
        const float p = expf(sv[u] - m_new);
        rsum += p;
        ps[r * LDP + c] = from_float<T>(p * vsc[c]);
      }
      for (int o = 16; o > 0; o >>= 1) rsum += __shfl_xor_sync(0xffffffffu, rsum, o);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + rsum;
        c_s[r] = corr;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < RT * D; i += kThreads) {
      const int r = i / D, dcol = i % D;
      os[r * LDO + dcol] *= c_s[r];
    }
    __syncthreads();

    // O += P V on the tensor cores, accumulator kept in shared memory
    for (int f = warp; f < (RT / 16) * (D / 16); f += kWarps) {
      const int fi = f / (D / 16), fj = f % (D / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, os + fi * 16 * LDO + fj * 16, LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < TK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bv;
        wmma::load_matrix_sync(a, ps + fi * 16 * LDP + kk, LDP);
        wmma::load_matrix_sync(bv, vs + kk * LDQ + fj * 16, LDQ);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(os + fi * 16 * LDO + fj * 16, acc, LDO, wmma::mem_row_major);
    }
  }
  __syncthreads();

  // normalized partial O and its LSE; empty rows: O = 0, LSE = -inf
  const size_t base = (static_cast<size_t>(split) * b + ib) * h_k + kvh;
  for (int i = threadIdx.x; i < RT * D; i += kThreads) {
    const int r = i / D, dcol = i % D;
    if (r0 + r >= R || dcol >= d) continue;
    const float l = l_s[r];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    o_part[(base * R + r0 + r) * d + dcol] = os[r * LDO + dcol] * inv;
  }
  for (int r = threadIdx.x; r < RT; r += kThreads) {
    if (r0 + r >= R) continue;
    const float l = l_s[r];
    lse_part[base * R + r0 + r] = l > 0.f ? m_s[r] + logf(l) : -__int_as_float(0x7f800000);
  }
}

// The launch arguments past the template choices.
struct Args {
  const void *q, *kp, *vp;
  const float *ksc, *vsc;
  const int32_t *bt, *lens;
  float *o, *lse;
  const float* alibi;
  const int32_t* leftpad;
  int b, sq, h_k, group, page, max_pages, n_splits, wl, wr;
  float softcap;
  int d;  // the head dim: the kernel's D is its rung (by_rung)
};

template <typename T, typename KV, int D, int RT, bool kExtra>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int smem = Smem<D, RT>::bytes;
  auto kernel = paged_attention_kernel<T, KV, D, RT, kExtra>;
  // raise the dynamic shared-memory limit once per instantiation (one
  // device), not on every launch: it is a CUDA API call on the decode path
  static bool smem_limit_set = false;
  if (!smem_limit_set) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_limit_set = true;
  }
  const int R = a.group * a.sq;
  dim3 grid((R + RT - 1) / RT, a.b * a.h_k, a.n_splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.kp),
      static_cast<const KV*>(a.vp), a.ksc, a.vsc, a.bt, a.lens, a.o, a.lse, a.alibi, a.leftpad,
      a.b, a.sq, a.h_k, a.group, a.page, a.max_pages, a.wl, a.wr, a.softcap, a.d);
  return cudaGetLastError();
}

// The option-free kernel unless a window start, a right window beyond the
// causal one, softcap, ALiBi or leftpad asks for the general one.
template <typename T, typename KV, int D, int RT>
cudaError_t launch_x(const Args& a, cudaStream_t st) {
  const bool extra = a.wl >= 0 || a.wr > 0 || a.softcap > 0.f || a.alibi != nullptr ||
                     a.leftpad != nullptr;
  return extra ? launch<T, KV, D, RT, true>(a, st) : launch<T, KV, D, RT, false>(a, st);
}

template <typename T, typename KV>
cudaError_t dispatch_d(int row_tile, const Args& a, cudaStream_t st) {
  if (row_tile != 16 && row_tile != 32) return cudaErrorInvalidValue;
  return by_rung(a.d, [&](auto rung) {
    constexpr int D = decltype(rung)::value;
    return row_tile == 16 ? launch_x<T, KV, D, 16>(a, st) : launch_x<T, KV, D, 32>(a, st);
  });
}


// ---- the Hopper route: paged_wgmma_kernel ---------------------------------------

namespace wg {

using namespace hopper;

constexpr int kBQ = 64;     // query rows per block: one consumer warpgroup
constexpr int kBK = 64;     // keys per tile
constexpr int kStages = 2;  // bf16 K/V ring
constexpr int kRaw = 2;     // byte staging ring of int8 / fp8 pools
constexpr int kThreadsWg = 128 + 128;  // the consumer warpgroup, then the producer warpgroup
// 128 registers a thread at launch (two blocks an SM where shared memory
// allows): the producer, which only issues TMA and converts bytes, hands
// registers to the consumer, which holds S (32 f32), P (16 words) and O
// (D / 2 f32). At the rungs 192 and 256 shared memory holds one block an SM,
// and the consumer takes 232 registers (O alone is 96 or 128).
constexpr int kProducerRegs = 56;
template <int D>
constexpr int kConsumerRegs = D >= 192 ? 232 : 200;
static_assert(2 * 128 * (kProducerRegs + kConsumerRegs<128>) <= 65536, "register file");
static_assert(128 * (kProducerRegs + kConsumerRegs<256>) <= 65536, "register file");
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one block, from a 1024-byte aligned base: the Q tile and
// the ring of (K tile, V tile) stages, each tile D / 64 sub-tiles of 64 rows
// x 64 bf16 columns (128-byte swizzled); for int8 / fp8 pools the staging
// ring of (K bytes, V bytes) tiles (64 rows of D bytes, unswizzled) and each
// bf16 stage's 64 K and 64 V scales; then the barriers. Two blocks fit an SM
// except for int8 / fp8 pools at D = 128 (116.8 KB, one block) and at the
// rungs 192 and 256 (121-226 KB, one block).
template <typename KV, int D>
struct Layout {
  static constexpr bool kQuant = sizeof(KV) == 1;
  static constexpr int kTileBytes = kBK * D * 2;
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kRingOffset = kBQ * D * 2;  // after the Q tile
  static constexpr int kRawTileBytes = kBK * D;
  static constexpr int kRawOffset = kRingOffset + kStages * kStageBytes;
  static constexpr int kScaleOffset = kRawOffset + (kQuant ? kRaw * 2 * kRawTileBytes : 0);
  static constexpr int kBarOffset = kScaleOffset + (kQuant ? kStages * 2 * kBK * 4 : 0);
  static constexpr int kBytes = kBarOffset + 8 * (2 * kStages + kRaw) + 1024;  // + alignment
  static_assert(kBytes <= 232448, "one block an SM");
};

struct Params {
  const void* q;             // (b, sq, h, d) of the kernel's T, not pre-scaled
  int64_t q_sb, q_st, q_sh;  // its (batch, token, head) strides in elements
  const float* k_scales;     // (L * pages, h_k, page) or null (bf16 pools)
  const float* v_scales;
  const int32_t* bt;    // (b, max_pages)
  const int32_t* lens;  // (b,)
  void* o;              // one split: (b, sq, h, d) of T; more: (splits, b, sq, h, d) f32
  float* lse;           // one split: (b, h, sq); more: (splits, b, sq, h)
  int b, sq, h_k, group, page, max_pages, n_splits, n_rt;
  int d;         // the head dim: the kernel's D is its rung, columns past d are zeros
  int page0;     // the layer's first page in the tensor maps
  int box_rows;  // keys per TMA box: the largest of 64, 32, 16, 8 dividing page
  int causal;    // the option-free instantiation's right window: 1 is 0, 0 none
  float scale;
  // the options (the kExtra instantiation): the window (wl, wr), < 0
  // unbounded, causal is wr = 0; the softcap, 0 none; ALiBi slopes (b, h)
  // f32 and the leftpad (b,) int32, null when absent
  int wl, wr;
  float softcap;
  const float* alibi;
  const int32_t* leftpad;
};

constexpr int kNoLimit = 0x7fffffff;  // a right limit of no window

// The options' leftpad of batch entry ib, and the first key its query row t
// can see: its window start, or the leftpad
__device__ __forceinline__ int leftpad_of(const Params& p, int ib) {
  return p.leftpad != nullptr ? max(0, p.leftpad[ib]) : 0;
}
__device__ __forceinline__ int first_key_of(const Params& p, int lp, int kv_len, int t) {
  return p.wl >= 0 ? max(lp, kv_len - p.sq + t - p.wl) : lp;
}

// The options' limits of one query row at position qpos: the first key it
// can see, the last (kNoLimit: none), and its ALiBi slope (0 without ALiBi)
struct RowLimits {
  int lo, hi;
  float slope;
};
__device__ __forceinline__ RowLimits row_limits(const Params& p, int lp, int qpos, int ib,
                                                int head) {
  return RowLimits{p.wl >= 0 ? max(lp, qpos - p.wl) : lp, p.wr >= 0 ? qpos + p.wr : kNoLimit,
                   p.alibi != nullptr ? p.alibi[ib * p.h_k * p.group + head] : 0.f};
}

// softcap, then ALiBi, of one score: what the options do to every key
__device__ __forceinline__ float score_options(const Params& p, float x, float slope, int qpos,
                                               int kcol) {
  if (p.softcap > 0.f) x = tanhf(x / p.softcap) * p.softcap;
  return x - slope * fabsf(static_cast<float>(qpos - kcol));
}

// 16 pool bytes -> 16 T (bf16 or f16) values, as two 16-byte words in order
template <typename T, typename KV>
__device__ __forceinline__ void bytes_to_x16(const uint4& raw, uint4& lo, uint4& hi) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t out[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = x2_from_bytes02<T, KV>(__byte_perm(w[i], 0, 0x4140));      // bytes 0, 1
    out[2 * i + 1] = x2_from_bytes02<T, KV>(__byte_perm(w[i], 0, 0x4342));  // bytes 2, 3
  }
  lo = make_uint4(out[0], out[1], out[2], out[3]);
  hi = make_uint4(out[4], out[5], out[6], out[7]);
}

// One staged byte tile (64 rows of D bytes) into a swizzled T tile; rows
// from `live` on are written as zeros. pt: the thread of the producer
// warpgroup.
template <typename T, typename KV, int D>
__device__ __forceinline__ void convert_tile(const unsigned char* raw, unsigned char* tile,
                                             int live, int pt) {
  constexpr int kChunks = kBK * D / 16;  // 16-byte chunks of the byte tile
  static_assert(kChunks % 128 == 0, "whole passes of the warpgroup");
#pragma unroll
  for (int it = 0; it < kChunks / 128; ++it) {
    const int c = pt + it * 128;
    const int j = c / (D / 16), dcol = (c % (D / 16)) * 16;
    uint4 bytes = make_uint4(0, 0, 0, 0), lo, hi;
    if (j < live) bytes = *reinterpret_cast<const uint4*>(raw + j * D + dcol);
    bytes_to_x16<T, KV>(bytes, lo, hi);
    // 16-byte chunk c16 of row j of sub-tile dcol / 64 sits at chunk c16 ^ (j % 8)
    unsigned char* row = tile + (dcol / 64) * kBK * 128 + j * 128;
    const int c16 = (dcol % 64) / 8;
    *reinterpret_cast<uint4*>(row + ((c16 ^ (j & 7)) << 4)) = lo;
    *reinterpret_cast<uint4*>(row + (((c16 + 1) ^ (j & 7)) << 4)) = hi;
  }
}

// a T pair times the softmax scale: f32 products rounded to T
template <typename T>
__device__ __forceinline__ uint32_t scaled_pair(uint32_t w, float scale) {
  const float2 f = unpack2<T>(w);
  return pack2<T>(f.x * scale, f.y * scale);
}

template <typename T, typename KV, int D, bool kExtra>
__global__ void __launch_bounds__(kThreadsWg, D >= 192 ? 1 : 2)
    paged_wgmma_kernel(const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using L = Layout<KV, D>;
  constexpr bool kQuant = L::kQuant;
  constexpr int kSub = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* full = bars;
  uint64_t* empty = bars + kStages;
  uint64_t* raw_full = bars + 2 * kStages;
  unsigned char* q_tile = smem;
  auto k_tile = [&](int st) { return smem + L::kRingOffset + st * L::kStageBytes; };
  auto v_tile = [&](int st) { return k_tile(st) + L::kTileBytes; };
  auto raw_k = [&](int rs) { return smem + L::kRawOffset + rs * 2 * L::kRawTileBytes; };
  auto raw_v = [&](int rs) { return raw_k(rs) + L::kRawTileBytes; };
  auto scales = [&](int st) {  // 64 K scales, then 64 V scales
    return reinterpret_cast<float*>(smem + L::kScaleOffset) + st * 2 * kBK;
  };

  // heaviest first: every (split, batch entry, KV head) at the last row
  // tile, then at the tile before it
  const int n_other = p.n_splits * p.b * p.h_k;
  const int rt = p.n_rt - 1 - static_cast<int>(blockIdx.x) / n_other;
  const int rest = static_cast<int>(blockIdx.x) % n_other;
  const int kvh = rest % p.h_k, ib = rest / p.h_k % p.b, split = rest / (p.h_k * p.b);
  const int R = p.group * p.sq;  // query rows of one KV head
  const int r0 = rt * kBQ;
  const int h = p.h_k * p.group;

  // the split's keys: its run of the live pages (with the options, from the
  // page of the first key any row can see), cut at kv_len and at the causal
  // or right limit of the block's last row; with the options the block
  // starts at its first row's earliest key, rounded down to a TMA box
  const int kv_len = p.lens[ib];
  const int n_live = min((kv_len + p.page - 1) / p.page, p.max_pages);
  const int t_first = min(r0 / p.group, p.sq - 1);
  const int t_last = min((min(r0 + kBQ, R) - 1) / p.group, p.sq - 1);
  int lp = 0, first_page = 0;
  if constexpr (kExtra) {
    lp = leftpad_of(p, ib);
    first_page = min(first_key_of(p, lp, kv_len, 0) / p.page, n_live);
  }
  const int pps = (n_live - first_page + p.n_splits - 1) / p.n_splits;
  const int lo = first_page + split * pps;
  int kstart = lo * p.page;
  int kend = min(min(lo + pps, n_live) * p.page, kv_len);
  if constexpr (kExtra) {
    kstart = max(kstart, first_key_of(p, lp, kv_len, t_first) / p.box_rows * p.box_rows);
    if (p.wr >= 0) kend = min(kend, kv_len - p.sq + t_last + 1 + p.wr);
  } else {
    if (p.causal) kend = min(kend, kv_len - p.sq + t_last + 1);
  }
  const int n_tiles = kend > kstart ? (kend - kstart + kBK - 1) / kBK : 0;
  const int32_t* bt_row = p.bt + static_cast<size_t>(ib) * p.max_pages;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 1);
    }
    if constexpr (kQuant) {
      for (int rs = 0; rs < kRaw; ++rs) mbar_init(&raw_full[rs], 1);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // ---- the producer warpgroup ----
    setmaxnreg_dec<kProducerRegs>();
    const int pt = threadIdx.x - 128;
    const int B = p.box_rows;
    // the TMA boxes of tile i below kend: K to dk, V to dv, reported to bar
    auto issue = [&](int i, unsigned char* dk, unsigned char* dv, uint64_t* bar) {
      const int k0 = kstart + i * kBK;
      const int nb = min(kBK / B, (kend - k0 + B - 1) / B);
      mbar_arrive_expect_tx(bar, nb * B * D * static_cast<int>(sizeof(KV)) * 2);
      for (int j = 0; j < nb; ++j) {
        const int key = k0 + j * B;
        const int pg = p.page0 + bt_row[key / p.page], row = key % p.page;
        if constexpr (kQuant) {
          tma_load_4d(dk + j * B * D, &tm_k, bar, 0, row, kvh, pg);
          tma_load_4d(dv + j * B * D, &tm_v, bar, 0, row, kvh, pg);
        } else {
#pragma unroll
          for (int s = 0; s < kSub; ++s) {
            tma_load_4d(dk + s * kBK * 128 + j * B * 128, &tm_k, bar, s * 64, row, kvh, pg);
            tma_load_4d(dv + s * kBK * 128 + j * B * 128, &tm_v, bar, s * 64, row, kvh, pg);
          }
        }
      }
    };
    if constexpr (!kQuant) {  // one lane: TMA straight into the ring
      if (pt == 0) {
        for (int i = 0; i < n_tiles; ++i) {
          const int st = i % kStages;
          mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
          issue(i, k_tile(st), v_tile(st), &full[st]);
        }
      }
    } else {  // bytes staged by TMA, converted to bf16 into the ring by all
      if (pt == 0) {
        for (int i = 0; i < min(kRaw, n_tiles); ++i) issue(i, raw_k(i), raw_v(i), &raw_full[i]);
      }
      float ks = 0.f, vs = 0.f;  // thread pt < 64: the scales of key pt of the next tile
      auto load_scales = [&](int i) {
        const int key = kstart + i * kBK + pt;
        ks = vs = 0.f;
        if (pt < kBK && key < kend) {
          const size_t so =
              (static_cast<size_t>(p.page0 + bt_row[key / p.page]) * p.h_k + kvh) * p.page +
              key % p.page;
          ks = p.k_scales[so];
          vs = p.v_scales[so];
        }
      };
      if (n_tiles > 0) load_scales(0);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages, rs = i % kRaw;
        mbar_wait(&raw_full[rs], (i / kRaw) & 1);
        mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
        const int live = kend - (kstart + i * kBK);
        convert_tile<T, KV, D>(raw_k(rs), k_tile(st), live, pt);
        convert_tile<T, KV, D>(raw_v(rs), v_tile(st), live, pt);
        if (pt < kBK) {
          scales(st)[pt] = ks;
          scales(st)[kBK + pt] = vs;
        }
        fence_proxy_async();  // the converted tiles are read by wgmma (the async proxy)
        named_barrier_sync(2, 128);
        if (pt == 0) {
          mbar_arrive(&full[st]);
          if (i + kRaw < n_tiles) issue(i + kRaw, raw_k(rs), raw_v(rs), &raw_full[rs]);
        }
        if (i + 1 < n_tiles) load_scales(i + 1);
      }
    }
    return;
  }

  // ---- the consumer warpgroup: rows row, row + 8 of each warp's 16 ----
  setmaxnreg_inc<kConsumerRegs<D>>();
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int row = r0 + warp * 16 + (lane >> 2);
  const int col = (lane & 3) * 2;  // its key (and O) columns in an 8-column group

  // the Q tile times the softmax scale (f32 products rounded to T) into
  // shared memory, 128-byte swizzled as a TMA box would write it; rows past
  // R and columns past d are zero. (With Q held as wgmma's A registers
  // instead, ptxas gave those registers to P at d = 64, measured on the card:
  // the second key tile's S read P.)
  for (int c = tid; c < kBQ * (D / 8); c += 128) {
    const int r = c / (D / 8), ch = c % (D / 8);  // row, 16-byte chunk
    const int gr = r0 + r;
    uint4 w = make_uint4(0, 0, 0, 0);
    if (gr < R && ch * 8 < p.d) {
      const int t = gr / p.group, head = kvh * p.group + gr % p.group;
      w = *reinterpret_cast<const uint4*>(static_cast<const T*>(p.q) + ib * p.q_sb +
                                          t * p.q_st + head * p.q_sh + ch * 8);
      w = make_uint4(scaled_pair<T>(w.x, p.scale), scaled_pair<T>(w.y, p.scale),
                     scaled_pair<T>(w.z, p.scale), scaled_pair<T>(w.w, p.scale));
    }
    *reinterpret_cast<uint4*>(q_tile + (ch / 8) * kBQ * 128 + r * 128 +
                              (((ch % 8) ^ (r & 7)) << 4)) = w;
  }
  fence_proxy_async();
  named_barrier_sync(1, 128);
  int qpos[2];  // the rows' positions: their causal limits
#pragma unroll
  for (int r = 0; r < 2; ++r) qpos[r] = kv_len - p.sq + min((row + 8 * r) / p.group, p.sq - 1);
  const int q_first = kv_len - p.sq + t_first;  // tiles ending at or before it need no mask
  // the options: each row's limits and slope; a tile is a boundary tile if
  // it reaches past the first row's right limit or starts below the last
  // row's first key (the latest of the rows')
  [[maybe_unused]] RowLimits lim[2];
  [[maybe_unused]] float qf[2];  // the rows' positions as floats, for ALiBi
  [[maybe_unused]] int hi_first = kNoLimit, lo_last = 0;
  if constexpr (kExtra) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lim[r] = row_limits(p, lp, qpos[r], ib, kvh * p.group + (row + 8 * r) % p.group);
      qf[r] = static_cast<float>(qpos[r]);
    }
    if (p.wr >= 0) hi_first = q_first + p.wr;
    lo_last = first_key_of(p, lp, kv_len, t_last);
  }

  float acc[D / 2];  // O: 8-column group n holds acc[4n .. 4n+3]
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[kBK / 2];  // S, then P, of one key tile
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) s[i] = 0.f;
  float m_row[2] = {M_FLOOR, M_FLOOR};
  float l_row[2] = {0.f, 0.f};  // this thread's part of the row sums
  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = kstart + i * kBK;
    const int st = i % kStages;
    mbar_wait(&full[st], (i / kStages) & 1);
    if constexpr (!kQuant) {
      if (k0 + kBK > kend) {  // V rows past kend were not loaded: zero them (0 x NaN)
        const int live = kend - k0;
#pragma unroll
        for (int sub = 0; sub < kSub; ++sub) {
          uint4* vt = reinterpret_cast<uint4*>(v_tile(st) + sub * kBK * 128);
          for (int x = live * 8 + tid; x < kBK * 8; x += 128) vt[x] = make_uint4(0, 0, 0, 0);
        }
        fence_proxy_async();
        named_barrier_sync(1, 128);
      }
    }
    // S = Q K^T
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t da = desc_sw128(q_tile + (kk / 4) * kBQ * 128 + (kk % 4) * 32, 16, 1024);
      const uint64_t db = desc_sw128(k_tile(st) + (kk / 4) * kBK * 128 + (kk % 4) * 32, 16, 1024);
      Wgmma<T, kBK>::ss(s, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // the K scale per column, and the mask on boundary tiles only
    const float* sc = scales(st);
    if constexpr (kQuant) {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const float2 kscl = *reinterpret_cast<const float2*>(sc + j * 8 + col);
        s[4 * j] *= kscl.x;
        s[4 * j + 1] *= kscl.y;
        s[4 * j + 2] *= kscl.x;
        s[4 * j + 3] *= kscl.y;
      }
    }
    if constexpr (kExtra) {  // softcap and ALiBi on every tile, the mask on boundary tiles
      if (p.softcap > 0.f) {
#pragma unroll
        for (int e = 0; e < kBK / 2; ++e) s[e] = tanhf(s[e] / p.softcap) * p.softcap;
      }
      if (p.alibi != nullptr) {  // positions as floats (exact below 2^24): no conversion a key
        const float kf0 = static_cast<float>(k0 + col);
#pragma unroll
        for (int e = 0; e < kBK / 2; ++e) {
          const int r = (e >> 1) & 1;
          const float kf = kf0 + static_cast<float>((e >> 2) * 8 + (e & 1));
          s[e] = fmaf(-lim[r].slope, fabsf(qf[r] - kf), s[e]);
        }
      }
      if (k0 + kBK > kend || k0 + kBK - 1 > hi_first || k0 < lo_last) {
#pragma unroll
        for (int e = 0; e < kBK / 2; ++e) {
          const int kcol = k0 + (e >> 2) * 8 + col + (e & 1);
          const RowLimits& l = lim[(e >> 1) & 1];
          if (kcol >= kend || kcol < l.lo || kcol > l.hi) s[e] = NEG_INF;
        }
      }
    } else if (k0 + kBK > kend || (p.causal && k0 + kBK - 1 > q_first)) {
#pragma unroll
      for (int e = 0; e < kBK / 2; ++e) {
        const int kcol = k0 + (e >> 2) * 8 + col + (e & 1);
        if (kcol >= kend || (p.causal && kcol > qpos[(e >> 1) & 1])) s[e] = NEG_INF;
      }
    }

    // the online-softmax update of both rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG_INF;
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
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[4 * n + 2 * r] *= corr;
        acc[4 * n + 2 * r + 1] *= corr;
      }
    }

    // O += P V: P times the V scale, rounded to T, packed as the A operand
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int e = 8 * kk + 2 * w;  // entries e, e + 1: key columns 8 (e >> 2) + col, + 1
        float v0 = s[e], v1 = s[e + 1];
        if constexpr (kQuant) {
          const float2 vscl = *reinterpret_cast<const float2*>(sc + kBK + (e >> 2) * 8 + col);
          v0 *= vscl.x;
          v1 *= vscl.y;
        }
        pa[kk][w] = pack2<T>(v0, v1);
      }
    }
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_rs_tb_rung<T, D>(acc, pa[kk], v_tile(st) + kk * 16 * 128, kBK * 128);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) fence_regs(pa[kk]);
    if (tid == 0) mbar_arrive(&empty[st]);  // the warpgroup is done with the stage
  }

  // epilogue: the four threads of a row hold parts of its sum; rows that saw
  // no key give O = 0 and LSE = -inf
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_row[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int gr = row + 8 * r;
    if (gr >= R) continue;
    const int t = gr / p.group, head = kvh * p.group + gr % p.group;
    const bool no_key = l <= 0.f;
    const float inv = no_key ? 0.f : 1.f / l;
    const float lse = no_key ? -INFINITY : m_row[r] + logf(l);
    // O's rows are d wide (d a multiple of 8): column groups past d stay unstored
    if (p.n_splits == 1) {
      T* orow = static_cast<T*>(p.o) + ((static_cast<size_t>(ib) * p.sq + t) * h + head) * p.d;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        if (n * 8 < p.d)
          *reinterpret_cast<uint32_t*>(orow + n * 8 + col) =
              pack2<T>(acc[4 * n + 2 * r] * inv, acc[4 * n + 2 * r + 1] * inv);
      if ((lane & 3) == 0) p.lse[(static_cast<size_t>(ib) * h + head) * p.sq + t] = lse;
    } else {
      const size_t ri = ((static_cast<size_t>(split) * p.b + ib) * p.sq + t) * h + head;
      float* orow = static_cast<float*>(p.o) + ri * p.d;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        if (n * 8 < p.d)
          *reinterpret_cast<float2*>(orow + n * 8 + col) =
              make_float2(acc[4 * n + 2 * r] * inv, acc[4 * n + 2 * r + 1] * inv);
      if ((lane & 3) == 0) p.lse[ri] = lse;
    }
  }
}

// the tensor-map element type of T
template <typename T>
constexpr CUtensorMapDataType map_type() {
  return std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// keys per TMA box: the largest of 64, 32, 16, 8 that divides the page, or 0
inline int box_rows(int page) {
  for (int b = 64; b >= 8; b /= 2)
    if (page % b == 0) return b;
  return 0;
}

// whether a call needs the kExtra instantiation (ops/paged.py::has_options)
inline bool has_options(const Params& prm) {
  return prm.wl >= 0 || prm.wr > 0 || prm.softcap > 0.f || prm.alibi != nullptr ||
         prm.leftpad != nullptr;
}

template <typename T, typename KV, int D, bool kExtra>
cudaError_t launch(const void* k_pool, const void* v_pool, int n_pool_pages, const Params& prm,
                   cudaStream_t stream) {
  using L = Layout<KV, D>;
  constexpr uint64_t es = sizeof(KV);
  CUtensorMap maps[2];
  const void* bases[2] = {k_pool, v_pool};
  // (d, page, h_k, L * pages) over every layer: the layer is a page
  // coordinate; the real d, so TMA zero-fills a box's columns past it
  const uint64_t d = static_cast<uint64_t>(prm.d);
  const uint64_t dims[4] = {d, static_cast<uint64_t>(prm.page), static_cast<uint64_t>(prm.h_k),
                            static_cast<uint64_t>(n_pool_pages)};
  const uint64_t strides[3] = {d * es, static_cast<uint64_t>(prm.page) * d * es,
                               static_cast<uint64_t>(prm.h_k) * prm.page * d * es};
  // byte pools: boxes of whole D-byte rows, unswizzled (staged); 16-bit
  // pools: 64-column boxes, 128-byte swizzled (the ring wgmma reads)
  const uint32_t box[4] = {L::kQuant ? static_cast<uint32_t>(D) : 64u,
                           static_cast<uint32_t>(prm.box_rows), 1, 1};
  for (int i = 0; i < 2; ++i) {
    cudaError_t err =
        L::kQuant ? make_map(&maps[i], CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, bases[i], dims, strides,
                             box, CU_TENSOR_MAP_SWIZZLE_NONE)
                  : make_map(&maps[i], map_type<T>(), 4, bases[i], dims, strides, box,
                             CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return err;
  }
  auto* kernel = &paged_wgmma_kernel<T, KV, D, kExtra>;
  static bool smem_limit_set = false;  // once per instantiation, as for the WMMA kernel
  if (!smem_limit_set) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return err;
    smem_limit_set = true;
  }
  const unsigned grid = static_cast<unsigned>(prm.n_rt) * prm.n_splits * prm.b * prm.h_k;
  kernel<<<grid, kThreadsWg, L::kBytes, stream>>>(maps[0], maps[1], prm);
  return cudaGetLastError();
}

template <typename T, typename KV, bool kExtra>
cudaError_t launch_x(const void* kp, const void* vp, int n_pool_pages, const Params& prm,
                     cudaStream_t stream) {
  return by_rung(prm.d, [&](auto rung) {
    return launch<T, KV, decltype(rung)::value, kExtra>(kp, vp, n_pool_pages, prm, stream);
  });
}

template <typename T, typename KV>
cudaError_t launch_d(const void* kp, const void* vp, int n_pool_pages, const Params& prm,
                     cudaStream_t stream) {
  return has_options(prm) ? launch_x<T, KV, true>(kp, vp, n_pool_pages, prm, stream)
                          : launch_x<T, KV, false>(kp, vp, n_pool_pages, prm, stream);
}

}  // namespace wg

// ---- the decode route: paged_decode_kernel and paged_combine_kernel -------------

namespace dec {

using namespace hopper;

constexpr int kTK = 64;     // keys per tile
constexpr int kWarps = 4;   // consumer warps: 16 keys of every tile each
constexpr int kThreadsDec = 32 * kWarps + 32;  // the consumers, then the producer warp
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one block, from a 1024-byte aligned base: the ring of
// (K tile, V tile) stages as the pool stores them (64 key rows of D values
// each, raw bytes for int8 / fp8), each tile kSub sub-tiles of 64 rows x kW
// bytes (kW = 128: the 128-byte swizzle, for rows of a multiple of 128
// bytes; else 64: the 64-byte swizzle), then each stage's 64 K and 64 V
// scales (int8 / fp8), then the barriers. The ring takes as many stages as
// an SM's 228 KB holds for kBlocks blocks (two, one at the rung 256, whose
// O and Q fragments take most of a thread's registers and whose 16-bit
// stage is 64 KB): 3 to 13, so that exactly kBlocks blocks are resident
// whatever the instantiation (the split heuristic counts them,
// ops/paged.py::DECODE_BLOCKS) and a long split keeps that many tiles in
// flight. After the loop the ring holds the warps' merge.
template <typename KV, int D>
struct Layout {
  static constexpr bool kQuant = sizeof(KV) == 1;
  static constexpr int kBlocks = D >= 256 ? 1 : 2;
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(KV));
  static constexpr int kW = kRowBytes % 128 == 0 ? 128 : 64;
  static constexpr int kSub = kRowBytes / kW;
  static constexpr int kTileBytes = kTK * kRowBytes;
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kSmSmem = 233472;  // an SM's shared memory, 1 KB a block reserved
  static constexpr int kStages =
      (kSmSmem / kBlocks - 2048) / (kStageBytes + (kQuant ? 2 * kTK * 4 : 0) + 16);
  static constexpr int kScaleOffset = kStages * kStageBytes;
  static constexpr int kBarOffset = kScaleOffset + (kQuant ? kStages * 2 * kTK * 4 : 0);
  static constexpr int kBytes = kBarOffset + 8 * 2 * kStages + 1024;  // + alignment
  static constexpr int kLdr = D + 8;  // f32 row of the merge buffer
  static_assert(kWarps * 16 * kLdr * 4 + 2 * kWarps * 16 * 4 <= kScaleOffset, "merge in ring");
  static_assert(kBlocks * (kBytes + 1024) <= kSmSmem && (kBlocks + 1) * (kBytes + 1024) > kSmSmem,
                "exactly kBlocks blocks an SM");
  static_assert(kRowBytes % kW == 0, "whole swizzle rows");
};

// byte offset of the 16-byte chunk cb (counted along the whole row) of key
// row j in a tile, as the swizzled TMA boxes wrote it: chunk c of a 128-byte
// row at c ^ (j % 8), of a 64-byte row at c ^ (j / 2 % 4), so the 8 rows of
// one ldmatrix matrix hit 8 distinct bank groups
template <int W>
__device__ __forceinline__ int tile_off(int j, int cb) {
  constexpr int kC = W / 16;
  const int x = W == 128 ? (j & 7) : ((j >> 1) & 3);
  return (cb / kC) * kTK * W + j * W + (((cb % kC) ^ x) << 4);
}

template <typename T, typename KV>
__device__ __forceinline__ uint32_t lo02(uint32_t w) { return x2_from_bytes02<T, KV>(w); }
template <typename T, typename KV>
__device__ __forceinline__ uint32_t hi13(uint32_t w) { return x2_from_bytes02<T, KV>(w >> 8); }

// q[i] times the softmax scale in f32 (packed with pack2: rounded to T)
template <typename T>
__device__ __forceinline__ float scaled(const T* q, int i, float scale) {
  return to_float(q[i]) * scale;
}

// Q's B fragments of the decode kernel, times the softmax scale (f32
// products rounded to T): k-step kk of bf16 K reads d 16kk + 2c, +1 and
// 16kk + 8 + 2c, +1; of byte K, d 16kk + 4c, +2 and 16kk + 4c + 1, +3. Rows
// past R are zero. kTail: the head dim p.d is below the rung D, and the
// columns past it are zero (d % 8 == 0, % 16 over byte pools: each half of a
// k-step lies all below d or all past it). Without kTail the loads are
// unguarded: a guard on each value made the prologue, which a decode block's
// short run waits on, and with it the d = 128 decode call 15 % slower on the
// card.
template <typename T, bool kQuant, int kMT, int NT, bool kTail>
__device__ __forceinline__ void q_fragments(uint32_t (&qb)[kMT][NT][2], const wg::Params& p,
                                            int ib, int kvh, int R, int g, int c) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int r = 8 * n + g;
    const T* qrow = nullptr;
    if (r < R)
      qrow = static_cast<const T*>(p.q) + ib * p.q_sb + (r / p.group) * p.q_st +
             (kvh * p.group + r % p.group) * p.q_sh;
#pragma unroll
    for (int kk = 0; kk < kMT; ++kk) {
      if (qrow == nullptr || (kTail && 16 * kk >= p.d)) {
        qb[kk][n][0] = qb[kk][n][1] = 0u;
      } else if constexpr (kQuant) {
        const int e = 16 * kk + 4 * c;
        qb[kk][n][0] = pack2<T>(scaled(qrow, e, p.scale), scaled(qrow, e + 2, p.scale));
        qb[kk][n][1] = pack2<T>(scaled(qrow, e + 1, p.scale), scaled(qrow, e + 3, p.scale));
      } else {
        const int e = 16 * kk + 2 * c;
        qb[kk][n][0] = pack2<T>(scaled(qrow, e, p.scale), scaled(qrow, e + 1, p.scale));
        if (kTail && 16 * kk + 8 >= p.d)
          qb[kk][n][1] = 0u;
        else
          qb[kk][n][1] = pack2<T>(scaled(qrow, e + 8, p.scale), scaled(qrow, e + 9, p.scale));
      }
    }
  }
}

// One block owns one (split, batch entry, KV head) and its R = sq * group
// <= 16 query rows t * group + g; NT = 1 for R <= 8, else 2 (8 rows each).
// Warp w of the four consumer warps takes keys 16w..16w+15 of every tile,
// with the keys as mma.sync's M: S^T = K Q^T (K from the ring by ldmatrix,
// Q as B fragments in registers), then O^T += V^T P^T (V by ldmatrix
// .trans, P^T from the S^T accumulators by movmatrix). Int8 / fp8 K and V
// become bf16 in registers, a byte pair at a time; the d order this gives
// (bytes 0, 2 then 1, 3 of each word) is the same in Q's fragments, and in
// O^T's rows the epilogue undoes it. Each warp keeps its own running max,
// sum and O^T; they are merged once at the end through shared memory.
// kExtra: the options (the module comment); each thread keeps its S^T
// columns' limits and slopes beside their positions.
template <typename T, typename KV, int D, int NT, bool kExtra>
__global__ void __launch_bounds__(kThreadsDec, Layout<KV, D>::kBlocks)
    paged_decode_kernel(const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, const wg::Params p) {
  using L = Layout<KV, D>;
  constexpr bool kQuant = L::kQuant;
  constexpr int kW = L::kW, kS = L::kStages;
  constexpr int kMT = D / 16;  // m-tiles of O^T
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* empty = full + kS;
  auto k_tile = [&](int st) { return smem + st * L::kStageBytes; };
  auto v_tile = [&](int st) { return k_tile(st) + L::kTileBytes; };
  auto scales = [&](int st) {  // 64 K scales, then 64 V scales
    return reinterpret_cast<float*>(smem + L::kScaleOffset) + st * 2 * kTK;
  };

  const int kvh = blockIdx.x % p.h_k, ib = blockIdx.x / p.h_k % p.b;
  const int split = blockIdx.x / (p.h_k * p.b);
  const int R = p.group * p.sq;
  const int h = p.h_k * p.group;

  // the split's keys: a run of whole 64-key tiles of the live keys, with
  // the options from the tile of the first key any row can see
  // (ops/paged.py::decode_split_keys); the last row's causal limit is kv_len
  const int kv_len = p.lens[ib];
  const int live = min(kv_len, p.max_pages * p.page);
  const int n_live_tiles = (live + kTK - 1) / kTK;
  int lp = 0, first_tile = 0;
  if constexpr (kExtra) {
    lp = wg::leftpad_of(p, ib);
    first_tile = min(wg::first_key_of(p, lp, kv_len, 0) / kTK, n_live_tiles);
  }
  const int tps = (n_live_tiles - first_tile + p.n_splits - 1) / p.n_splits;
  const int kstart = min((first_tile + split * tps) * kTK, live);
  const int kend = min(kstart + tps * kTK, live);
  const int n_tiles = (kend - kstart + kTK - 1) / kTK;
  const int32_t* bt_row = p.bt + static_cast<size_t>(ib) * p.max_pages;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kS; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == kWarps) {  // ---- the producer warp: one lane issues every copy ----
    if (lane == 0) {
      const int B = p.box_rows;
      constexpr int kBoxCols = kW / static_cast<int>(sizeof(KV));
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kS;
        mbar_wait(&empty[st], ((i / kS) & 1) ^ 1);
        const int k0 = kstart + i * kTK;
        const int nb = min(kTK / B, (kend - k0 + B - 1) / B);
        mbar_arrive_expect_tx(&full[st], nb * B * (2 * L::kRowBytes + (kQuant ? 8 : 0)));
        for (int j = 0; j < nb; ++j) {
          const int key = k0 + j * B;
          const int pg = p.page0 + bt_row[key / p.page], row = key % p.page;
#pragma unroll
          for (int s = 0; s < L::kSub; ++s) {
            tma_load_4d(k_tile(st) + s * kTK * kW + j * B * kW, &tm_k, &full[st], s * kBoxCols,
                        row, kvh, pg);
            tma_load_4d(v_tile(st) + s * kTK * kW + j * B * kW, &tm_v, &full[st], s * kBoxCols,
                        row, kvh, pg);
          }
          if constexpr (kQuant) {
            const size_t so = (static_cast<size_t>(pg) * p.h_k + kvh) * p.page + row;
            bulk_load(scales(st) + j * B, p.k_scales + so, B * 4, &full[st]);
            bulk_load(scales(st) + kTK + j * B, p.v_scales + so, B * 4, &full[st]);
          }
        }
      }
    }
    return;
  }

  // ---- the consumer warps ----
  const int g = lane >> 2, c = lane & 3;
  const int kw = 16 * warp;  // the warp's keys in every tile

  // Q's B fragments (q_fragments): a block's one uniform branch on the head dim
  uint32_t qb[kMT][NT][2];
  if (p.d == D)
    q_fragments<T, kQuant, kMT, NT, false>(qb, p, ib, kvh, R, g, c);
  else
    q_fragments<T, kQuant, kMT, NT, true>(qb, p, ib, kvh, R, g, c);
  // the causal limit of this thread's S^T columns: rows 8n + 2c + e
  int qpos[NT][2];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      qpos[n][e] = kv_len - p.sq + min((8 * n + 2 * c + e) / p.group, p.sq - 1);
  const int q_first = kv_len - p.sq;  // tiles ending at or before it need no causal mask
  // the options: the columns' limits and slopes; a tile is a boundary tile
  // if it reaches past the first row's right limit or starts below the last
  // row's first key (the latest of the rows')
  [[maybe_unused]] wg::RowLimits lim[NT][2];
  [[maybe_unused]] int hi_first = wg::kNoLimit, lo_last = 0;
  if constexpr (kExtra) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        lim[n][e] = wg::row_limits(p, lp, qpos[n][e], ib,
                                   kvh * p.group + (8 * n + 2 * c + e) % p.group);
    if (p.wr >= 0) hi_first = q_first + p.wr;
    lo_last = wg::first_key_of(p, lp, kv_len, p.sq - 1);
  }

  float acc[kMT][NT][4];  // O^T: m-tile (16 d) x n-tile (8 rows)
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][n][j] = 0.f;
  float m_r[NT][2], l_r[NT][2];  // running max and this thread's part of the sum
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      m_r[n][e] = M_FLOOR;
      l_r[n][e] = 0.f;
    }

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kS;
    const int k0 = kstart + i * kTK;
    mbar_wait(&full[st], (i / kS) & 1);
    const unsigned char* kt = k_tile(st);
    const unsigned char* vt = v_tile(st);

    // S^T = K Q^T over the warp's 16 keys: s[n][0..1] key g, [2..3] key g + 8
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[n][j] = 0.f;
#pragma unroll
    for (int kx = 0; kx < L::kRowBytes / 32; ++kx) {
      uint32_t r[4];
      ldmatrix_x4(r, kt + tile_off<kW>(kw + (lane & 7) + ((lane >> 3) & 1) * 8,
                                       2 * kx + (lane >> 4)));
      if constexpr (kQuant) {
        const uint32_t a0[4] = {lo02<T, KV>(r[0]), lo02<T, KV>(r[1]), hi13<T, KV>(r[0]),
                                hi13<T, KV>(r[1])};
        const uint32_t a1[4] = {lo02<T, KV>(r[2]), lo02<T, KV>(r[3]), hi13<T, KV>(r[2]),
                                hi13<T, KV>(r[3])};
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          mma_16816<T>(s[n], a0, qb[2 * kx][n]);
          mma_16816<T>(s[n], a1, qb[2 * kx + 1][n]);
        }
      } else {
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_16816<T>(s[n], r, qb[kx][n]);
      }
    }

    // the K scale per key (then the options' softcap and ALiBi); keys past
    // kend or a row's limits masked on boundary tiles
    const int key0 = k0 + kw + g, key8 = key0 + 8;
    float ks0 = 1.f, ks8 = 1.f, vs0 = 1.f, vs8 = 1.f;
    if constexpr (kQuant) {
      const float* sc = scales(st);
      ks0 = sc[kw + g];
      ks8 = sc[kw + g + 8];
      vs0 = sc[kTK + kw + g];
      vs8 = sc[kTK + kw + g + 8];
    }
    if constexpr (kExtra) {  // softcap and ALiBi on every tile, the mask on boundary tiles
      const bool boundary = k0 + kTK > kend || k0 + kTK - 1 > hi_first || k0 < lo_last;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const wg::RowLimits& l = lim[n][e];
          s[n][e] = wg::score_options(p, s[n][e] * ks0, l.slope, qpos[n][e], key0);
          s[n][2 + e] = wg::score_options(p, s[n][2 + e] * ks8, l.slope, qpos[n][e], key8);
          if (boundary) {
            if (key0 >= kend || key0 < l.lo || key0 > l.hi) s[n][e] = NEG_INF;
            if (key8 >= kend || key8 < l.lo || key8 > l.hi) s[n][2 + e] = NEG_INF;
          }
        }
    } else {
      const bool boundary = k0 + kTK > kend || (p.causal && k0 + kTK - 1 > q_first);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[n][e] *= ks0;
          s[n][2 + e] *= ks8;
          if (boundary) {
            if (key0 >= kend || (p.causal && key0 > qpos[n][e])) s[n][e] = NEG_INF;
            if (key8 >= kend || (p.causal && key8 > qpos[n][e])) s[n][2 + e] = NEG_INF;
          }
        }
    }

    // the online-softmax update of each row; P times the V scale (0 past
    // kend, where the scale was not loaded), rounded to T, as P^T's B
    // fragments
    uint32_t pb[NT][2];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float pv[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float mx = fmaxf(s[n][e], s[n][2 + e]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float m_new = fmaxf(m_r[n][e], mx);
        const float corr = exp2f((m_r[n][e] - m_new) * kLog2e);  // exactly 1 when m holds
        const float m_l2 = m_new * kLog2e;
        m_r[n][e] = m_new;
        const float p0 = exp2f(fmaf(s[n][e], kLog2e, -m_l2));
        const float p8 = exp2f(fmaf(s[n][2 + e], kLog2e, -m_l2));
        l_r[n][e] = l_r[n][e] * corr + p0 + p8;
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          acc[mt][n][e] *= corr;
          acc[mt][n][2 + e] *= corr;
        }
        pv[e] = key0 < kend ? p0 * vs0 : 0.f;
        pv[2 + e] = key8 < kend ? p8 * vs8 : 0.f;
      }
      pb[n][0] = movmatrix_trans(pack2<T>(pv[0], pv[1]));
      pb[n][1] = movmatrix_trans(pack2<T>(pv[2], pv[3]));
    }

    // O^T += V^T P^T; on a boundary tile the V of keys past kend (stale or
    // unloaded bytes, maybe NaN) is zeroed in registers
    const int n_live = kend - k0 - kw;  // of the warp's 16 keys
    const uint32_t mask_lo = (2 * c < n_live ? 0x0000FFFFu : 0u) |
                             (2 * c + 1 < n_live ? 0xFFFF0000u : 0u);
    const uint32_t mask_hi = (2 * c + 8 < n_live ? 0x0000FFFFu : 0u) |
                             (2 * c + 9 < n_live ? 0xFFFF0000u : 0u);
#pragma unroll
    for (int q2 = 0; q2 < L::kRowBytes / 32; ++q2) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, vt + tile_off<kW>(kw + (lane & 7) + ((lane >> 4) & 1) * 8,
                                             2 * q2 + ((lane >> 3) & 1)));
      if (n_live < 16) {
        r[0] &= mask_lo;
        r[1] &= mask_lo;
        r[2] &= mask_hi;
        r[3] &= mask_hi;
      }
      if constexpr (kQuant) {
        const uint32_t a0[4] = {lo02<T, KV>(r[0]), lo02<T, KV>(r[1]), lo02<T, KV>(r[2]),
                                lo02<T, KV>(r[3])};
        const uint32_t a1[4] = {hi13<T, KV>(r[0]), hi13<T, KV>(r[1]), hi13<T, KV>(r[2]),
                                hi13<T, KV>(r[3])};
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          mma_16816<T>(acc[2 * q2][n], a0, pb[n]);
          mma_16816<T>(acc[2 * q2 + 1][n], a1, pb[n]);
        }
      } else {
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_16816<T>(acc[q2][n], r, pb[n]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // the warp is done with the stage
  }

  // ---- the merge of the four warps, through the drained ring ----
  // O^T row (m-tile mt, fragment row g or g + 8) -> d
  auto d_of = [&](int mt, int hi) {
    if constexpr (kQuant) return 32 * (mt / 2) + 16 * hi + 2 * g + (mt & 1);
    else return 16 * mt + 8 * hi + g;
  };
  float* red = reinterpret_cast<float*>(smem);  // [warp][row][kLdr]
  float* m_s = red + kWarps * 16 * L::kLdr;     // [warp][row]
  float* l_s = m_s + kWarps * 16;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float l = l_r[n][e];
      l += __shfl_xor_sync(0xffffffffu, l, 4);
      l += __shfl_xor_sync(0xffffffffu, l, 8);
      l += __shfl_xor_sync(0xffffffffu, l, 16);
      l_r[n][e] = l;
    }
  named_barrier_sync(1, 32 * kWarps);  // every warp is past the ring
  if (g == 0) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        m_s[warp * 16 + 8 * n + 2 * c + e] = m_r[n][e];
        l_s[warp * 16 + 8 * n + 2 * c + e] = l_r[n][e];
      }
  }
  named_barrier_sync(1, 32 * kWarps);
  // each warp's O^T times exp(m_w - M) / L, M and L over the four warps
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = 8 * n + 2 * c + e;
      float M = m_s[row];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) M = fmaxf(M, m_s[w * 16 + row]);
      float Lsum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        Lsum += exp2f((m_s[w * 16 + row] - M) * kLog2e) * l_s[w * 16 + row];
      const float f = Lsum > 0.f ? exp2f((m_r[n][e] - M) * kLog2e) / Lsum : 0.f;
      float* out = red + (warp * 16 + row) * L::kLdr;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        out[d_of(mt, 0)] = acc[mt][n][e] * f;
        out[d_of(mt, 1)] = acc[mt][n][2 + e] * f;
      }
    }
  named_barrier_sync(1, 32 * kWarps);

  // the sum over the warps, in the caller's layout: one split writes O
  // (b, sq, h, d) of T and LSE (b, h, sq); more write f32 partials
  // (splits, b, sq, h, d) and (splits, b, sq, h) (d a multiple of 4: the
  // columns past it are never stored). Rows that saw no key give O = 0 and
  // LSE = -inf.
  const int tid = threadIdx.x;
  for (int x = tid; x < R * (D / 4); x += 32 * kWarps) {
    const int row = x / (D / 4), d4 = (x % (D / 4)) * 4;
    if (d4 >= p.d) continue;
    float4 o = *reinterpret_cast<const float4*>(red + row * L::kLdr + d4);
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float4 y = *reinterpret_cast<const float4*>(red + (w * 16 + row) * L::kLdr + d4);
      o.x += y.x;
      o.y += y.y;
      o.z += y.z;
      o.w += y.w;
    }
    const int t = row / p.group, head = kvh * p.group + row % p.group;
    const size_t ri = (static_cast<size_t>(ib) * p.sq + t) * h + head;
    if (p.n_splits == 1) {
      *reinterpret_cast<uint2*>(static_cast<T*>(p.o) + ri * p.d + d4) =
          make_uint2(pack2<T>(o.x, o.y), pack2<T>(o.z, o.w));
    } else {
      const size_t pi = static_cast<size_t>(split) * p.b * p.sq * h + ri;
      *reinterpret_cast<float4*>(static_cast<float*>(p.o) + pi * p.d + d4) = o;
    }
  }
  if (tid < R) {
    float M = m_s[tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) M = fmaxf(M, m_s[w * 16 + tid]);
    float Lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      Lsum += exp2f((m_s[w * 16 + tid] - M) * kLog2e) * l_s[w * 16 + tid];
    const float lse = Lsum > 0.f ? M + logf(Lsum) : -INFINITY;
    const int t = tid / p.group, head = kvh * p.group + tid % p.group;
    if (p.n_splits == 1)
      p.lse[(static_cast<size_t>(ib) * h + head) * p.sq + t] = lse;
    else
      p.lse[(static_cast<size_t>(split) * p.b * p.sq + static_cast<size_t>(ib) * p.sq + t) * h +
            head] = lse;
  }
}

template <typename T, typename KV, int D, int NT, bool kExtra>
cudaError_t prepare() {
  // raise the dynamic shared-memory limit once per instantiation (one device)
  static cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<T, KV, D, NT, kExtra>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                Layout<KV, D>::kBytes);
  return err;
}

template <typename T, typename KV, int D, int NT, bool kExtra>
cudaError_t launch(const void* k_pool, const void* v_pool, int n_pool_pages,
                   const wg::Params& prm, cudaStream_t stream) {
  using L = Layout<KV, D>;
  constexpr uint64_t es = sizeof(KV);
  CUtensorMap maps[2];
  const void* bases[2] = {k_pool, v_pool};
  // (d, page, h_k, L * pages) over every layer: the layer is a page
  // coordinate; the real d, so TMA zero-fills a box's columns past it
  const uint64_t d = static_cast<uint64_t>(prm.d);
  const uint64_t dims[4] = {d, static_cast<uint64_t>(prm.page), static_cast<uint64_t>(prm.h_k),
                            static_cast<uint64_t>(n_pool_pages)};
  const uint64_t strides[3] = {d * es, static_cast<uint64_t>(prm.page) * d * es,
                               static_cast<uint64_t>(prm.h_k) * prm.page * d * es};
  const uint32_t box[4] = {static_cast<uint32_t>(L::kW / es),
                           static_cast<uint32_t>(prm.box_rows), 1, 1};
  const CUtensorMapSwizzle swizzle =
      L::kW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  for (int i = 0; i < 2; ++i) {
    cudaError_t err = make_map(
        &maps[i], L::kQuant ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : wg::map_type<T>(), 4, bases[i],
        dims, strides, box, swizzle);
    if (err != cudaSuccess) return err;
  }
  cudaError_t err = prepare<T, KV, D, NT, kExtra>();
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>(prm.n_splits) * prm.b * prm.h_k;
  paged_decode_kernel<T, KV, D, NT, kExtra>
      <<<grid, kThreadsDec, L::kBytes, stream>>>(maps[0], maps[1], prm);
  return cudaGetLastError();
}

template <typename T, typename KV, int NT, bool kExtra>
cudaError_t launch_d(const void* kp, const void* vp, int n_pool_pages, const wg::Params& prm,
                     cudaStream_t stream) {
  return by_rung(prm.d, [&](auto rung) {
    return dec::launch<T, KV, decltype(rung)::value, NT, kExtra>(kp, vp, n_pool_pages, prm,
                                                                  stream);
  });
}

template <typename T, typename KV, bool kExtra>
cudaError_t launch_x(const void* kp, const void* vp, int n_pool_pages, const wg::Params& prm,
                     cudaStream_t stream) {
  return prm.sq * prm.group <= 8
             ? dec::launch_d<T, KV, 1, kExtra>(kp, vp, n_pool_pages, prm, stream)
             : dec::launch_d<T, KV, 2, kExtra>(kp, vp, n_pool_pages, prm, stream);
}

template <typename T, typename KV>
cudaError_t launch_rows(const void* kp, const void* vp, int n_pool_pages, const wg::Params& prm,
                        cudaStream_t stream) {
  if (prm.sq * prm.group > 16) return cudaErrorInvalidValue;
  return wg::has_options(prm) ? dec::launch_x<T, KV, true>(kp, vp, n_pool_pages, prm, stream)
                              : dec::launch_x<T, KV, false>(kp, vp, n_pool_pages, prm, stream);
}

template <typename T, typename KV, int D, int NT, bool kExtra>
int blocks_per_sm() {
  int n = -1;
  if (prepare<T, KV, D, NT, kExtra>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, paged_decode_kernel<T, KV, D, NT, kExtra>,
                                                    kThreadsDec, Layout<KV, D>::kBytes) !=
          cudaSuccess)
    return -1;
  return n;
}

// The merge of split partials: one warp per (batch entry, token, head) row,
// the splits' weights exp(LSE_s - max) in split order, O in TO (bf16, f16 or
// f32: the queries' dtype).
template <typename TO, int D>
__global__ void __launch_bounds__(128) paged_combine_kernel(
    const float* __restrict__ o_part,    // (splits, b, sq, h, D)
    const float* __restrict__ lse_part,  // (splits, b, sq, h)
    TO* __restrict__ o,                  // (b, sq, h, D)
    float* __restrict__ lse,             // (b, h, sq)
    int n_splits, int b, int sq, int h) {
  constexpr int V = D / 32;  // columns a lane
  const int rows = b * sq * h;
  const int r = blockIdx.x * 4 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (r >= rows) return;
  float m = -INFINITY;
  for (int s = lane; s < n_splits; s += 32)
    m = fmaxf(m, lse_part[static_cast<size_t>(s) * rows + r]);
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float m_safe = isfinite(m) ? m : 0.f;
  float sumw = 0.f, acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const float ls = lse_part[static_cast<size_t>(s) * rows + r];
    if (!isfinite(ls)) continue;  // an empty partial
    const float w = expf(ls - m_safe);
    sumw += w;
    const float* src = o_part + (static_cast<size_t>(s) * rows + r) * D + lane * V;
    if constexpr (V == 4) {
      const float4 x = *reinterpret_cast<const float4*>(src);
      acc[0] += w * x.x;
      acc[1] += w * x.y;
      acc[2] += w * x.z;
      acc[3] += w * x.w;
    } else {
      const float2 x = *reinterpret_cast<const float2*>(src);
      acc[0] += w * x.x;
      acc[1] += w * x.y;
    }
  }
  const bool has = sumw > 0.f;
  const float inv = has ? 1.f / sumw : 0.f;
  TO* dst = o + static_cast<size_t>(r) * D + lane * V;
#pragma unroll
  for (int j = 0; j < V; j += 2) {
    if constexpr (std::is_same<TO, float>::value)
      *reinterpret_cast<float2*>(dst + j) = make_float2(acc[j] * inv, acc[j + 1] * inv);
    else
      *reinterpret_cast<uint32_t*>(dst + j) = pack2<TO>(acc[j] * inv, acc[j + 1] * inv);
  }
  if (lane == 0) {
    const int head = r % h, t = r / h % sq, ib = r / (h * sq);
    lse[(static_cast<size_t>(ib) * h + head) * sq + t] = has ? m_safe + logf(sumw) : -INFINITY;
  }
}

// The same merge at any other head dim d (a multiple of 4, at most 256):
// lane l takes the four columns from 4 l and from 4 l + 128.
template <typename TO>
__global__ void __launch_bounds__(128) paged_combine_kernel_any(
    const float* __restrict__ o_part,    // (splits, b, sq, h, d)
    const float* __restrict__ lse_part,  // (splits, b, sq, h)
    TO* __restrict__ o,                  // (b, sq, h, d)
    float* __restrict__ lse,             // (b, h, sq)
    int n_splits, int b, int sq, int h, int d) {
  const int rows = b * sq * h;
  const int r = blockIdx.x * 4 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (r >= rows) return;
  float m = -INFINITY;
  for (int s = lane; s < n_splits; s += 32)
    m = fmaxf(m, lse_part[static_cast<size_t>(s) * rows + r]);
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float m_safe = isfinite(m) ? m : 0.f;
  float sumw = 0.f;
  float4 acc[2] = {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
  for (int s = 0; s < n_splits; ++s) {
    const float ls = lse_part[static_cast<size_t>(s) * rows + r];
    if (!isfinite(ls)) continue;  // an empty partial
    const float w = expf(ls - m_safe);
    sumw += w;
    const float* src = o_part + (static_cast<size_t>(s) * rows + r) * d;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = 4 * lane + 128 * j;
      if (c < d) {
        const float4 x = *reinterpret_cast<const float4*>(src + c);
        acc[j].x += w * x.x;
        acc[j].y += w * x.y;
        acc[j].z += w * x.z;
        acc[j].w += w * x.w;
      }
    }
  }
  const bool has = sumw > 0.f;
  const float inv = has ? 1.f / sumw : 0.f;
  TO* dst = o + static_cast<size_t>(r) * d;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c = 4 * lane + 128 * j;
    if (c >= d) continue;
    const float4 x = make_float4(acc[j].x * inv, acc[j].y * inv, acc[j].z * inv, acc[j].w * inv);
    if constexpr (std::is_same<TO, float>::value)
      *reinterpret_cast<float4*>(dst + c) = x;
    else
      *reinterpret_cast<uint2*>(dst + c) = make_uint2(pack2<TO>(x.x, x.y), pack2<TO>(x.z, x.w));
  }
  if (lane == 0) {
    const int head = r % h, t = r / h % sq, ib = r / (h * sq);
    lse[(static_cast<size_t>(ib) * h + head) * sq + t] = has ? m_safe + logf(sumw) : -INFINITY;
  }
}

}  // namespace dec

// ---- the f32 route: paged_f32_kernel ------------------------------------------

namespace sim {

constexpr int kRT = 16;   // query rows per block
constexpr int kTK = 64;   // keys per tile
constexpr int kThreadsF32 = 128;

// Shared memory of one block: the scaled Q rows, the K tile (rows padded to
// D + 1 floats: the score loop's lanes read 32 keys' column d from 32
// banks), the V tile, the scores (then P), the rows' running max, sum and
// correction, and the tile's K and V scales.
template <int D>
struct Smem {
  static constexpr int LDK = D + 1;
  static constexpr int LDS = kTK + 1;
  static constexpr int q = 0;
  static constexpr int k = q + kRT * D;
  static constexpr int v = k + kTK * LDK;
  static constexpr int s = v + kTK * D;
  static constexpr int stats = s + kRT * LDS;  // m, l, corr: 3 * kRT
  static constexpr int scales = stats + 3 * kRT;  // ks, vs: 2 * kTK
  static constexpr int floats = scales + 2 * kTK;
  static constexpr int bytes = floats * 4;
};

// One block owns kRT query rows (t * group + g) of one (split, batch entry,
// KV head); the split's keys are its run of the live pages, as on the WMMA
// route. Per 64-key tile: the K and V rows of any pool dtype are converted to
// f32 into shared memory (exact; columns past the head dim d are zeros), S =
// Q K^T by FMA (thread: one key, 8 rows), the K scale, softcap, ALiBi and
// the masks, an online softmax per row (a warp a row), P times the V scale,
// and O += P V by FMA (thread: one column of D, kRT * D / 128 rows, in
// registers; at D 192 and 256 the columns tid and tid + 128, all kRT rows).
// The options are read at run time: one instantiation a (pool dtype, D).
template <typename KV, int D>
__global__ void __launch_bounds__(kThreadsF32) paged_f32_kernel(const KV* __restrict__ k_pool,
                                                                const KV* __restrict__ v_pool,
                                                                const wg::Params p) {
  using L = Smem<D>;
  constexpr int CH = 16 / sizeof(KV);  // values per 16-byte chunk
  constexpr int NC = D > kThreadsF32 ? 2 : 1;            // O columns per thread
  constexpr int CPT = D > kThreadsF32 ? 1 : kThreadsF32 / D;  // threads per O column (1 or 2)
  constexpr int RPT = kRT / CPT;        // O rows per thread
  extern __shared__ __align__(16) float sm[];
  float* qs = sm + L::q;
  float* ks = sm + L::k;
  float* vs = sm + L::v;
  float* ss = sm + L::s;
  float* m_s = sm + L::stats;
  float* l_s = m_s + kRT;
  float* c_s = l_s + kRT;
  float* ksc = sm + L::scales;
  float* vsc = ksc + kTK;

  const int R = p.group * p.sq;
  const int r0 = blockIdx.x * kRT;
  const int ib = blockIdx.y / p.h_k, kvh = blockIdx.y % p.h_k;
  const int split = blockIdx.z;
  const int h = p.h_k * p.group;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* q = static_cast<const float*>(p.q);

  const int kv_len = p.lens[ib];
  const int n_live = min((kv_len + p.page - 1) / p.page, p.max_pages);
  const int lp = wg::leftpad_of(p, ib);
  const int first_page = min(max(wg::first_key_of(p, lp, kv_len, 0), 0) / p.page, n_live);
  const int pps = (n_live - first_page + p.n_splits - 1) / p.n_splits;
  const int lo = first_page + split * pps;
  const int hi = min(lo + pps, n_live);
  const int t_first = min(r0 / p.group, p.sq - 1);
  const int t_last = min((min(r0 + kRT, R) - 1) / p.group, p.sq - 1);
  const int kstart = max(lo * p.page, wg::first_key_of(p, lp, kv_len, t_first));
  int kend = min(hi * p.page, kv_len);
  if (p.wr >= 0) kend = min(kend, kv_len - p.sq + t_last + 1 + p.wr);

  // Q times the softmax scale (rows past R are zero), the stats
  for (int i = tid; i < kRT * D; i += kThreadsF32) {
    const int r = i / D, dc = i % D, gr = r0 + r;
    float x = 0.f;
    if (gr < R && dc < p.d) {
      const int t = gr / p.group, head = kvh * p.group + gr % p.group;
      x = q[ib * p.q_sb + t * p.q_st + head * p.q_sh + dc] * p.scale;
    }
    qs[i] = x;
  }
  for (int i = tid; i < kRT; i += kThreadsF32) {
    m_s[i] = M_FLOOR;
    l_s[i] = 0.f;
  }
  float acc[NC][RPT];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[c][i] = 0.f;
  // O rows orow0 + CPT * i of the columns ocol (and ocol + 128 where NC = 2,
  // read at D - 1 and never stored past D)
  const int ocol = tid % D, orow0 = tid / D;
  const int ocol1 = NC > 1 ? min(ocol + kThreadsF32, D - 1) : ocol;

  const int32_t* bt_row = p.bt + static_cast<size_t>(ib) * p.max_pages;
  const size_t head_stride = static_cast<size_t>(p.page) * p.d;
  for (int k0 = kstart; k0 < kend; k0 += kTK) {
    __syncthreads();  // the previous tile is consumed
    // K and V rows as f32 (keys past kend as zeros), and their scales: the
    // 16-byte chunks of kU passes loaded together, then converted
    constexpr int kLoads = kTK * (D / CH) / kThreadsF32, kU = kLoads < 4 ? kLoads : 4;
#pragma unroll
    for (int it0 = 0; it0 < kLoads; it0 += kU) {
      uint4 kr[kU], vr[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int c = tid + (it0 + u) * kThreadsF32;
        const int kp = k0 + c / (D / CH), dc = (c % (D / CH)) * CH;
        kr[u] = vr[u] = make_uint4(0, 0, 0, 0);
        if (kp < kend && dc < p.d) {
          const size_t off =
              (static_cast<size_t>(p.page0 + bt_row[kp / p.page]) * p.h_k + kvh) * head_stride +
              static_cast<size_t>(kp % p.page) * p.d + dc;
          kr[u] = *reinterpret_cast<const uint4*>(k_pool + off);
          vr[u] = *reinterpret_cast<const uint4*>(v_pool + off);
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int c = tid + (it0 + u) * kThreadsF32;
        const int j = c / (D / CH), dc = (c % (D / CH)) * CH;
        const KV* kv = reinterpret_cast<const KV*>(&kr[u]);
        const KV* vv = reinterpret_cast<const KV*>(&vr[u]);
#pragma unroll
        for (int e = 0; e < CH; ++e) {
          ks[j * L::LDK + dc + e] = to_float(kv[e]);
          vs[j * D + dc + e] = to_float(vv[e]);
        }
      }
    }
    if (tid < kTK) {
      const int kp = k0 + tid;
      float kscale = 1.f, vscale = 0.f;  // P of a key past kend is 0
      if (kp < kend) {
        vscale = 1.f;
        if (p.k_scales != nullptr) {
          const size_t so =
              (static_cast<size_t>(p.page0 + bt_row[kp / p.page]) * p.h_k + kvh) * p.page +
              kp % p.page;
          kscale = p.k_scales[so];
          vscale = p.v_scales[so];
        }
      }
      ksc[tid] = kscale;
      vsc[tid] = vscale;
    }
    __syncthreads();

    // S = Q K^T: thread tid takes key tid % 64 of rows tid / 64 + 2 i
    {
      const int j = tid % kTK, rb = tid / kTK;
      float sacc[kRT / 2];
#pragma unroll
      for (int i = 0; i < kRT / 2; ++i) sacc[i] = 0.f;
      const float* krow = ks + j * L::LDK;
#pragma unroll 4
      for (int dd = 0; dd < D; ++dd) {
        const float kv = krow[dd];
#pragma unroll
        for (int i = 0; i < kRT / 2; ++i) sacc[i] = fmaf(qs[(rb + 2 * i) * D + dd], kv, sacc[i]);
      }
      const int kcol = k0 + j;
#pragma unroll
      for (int i = 0; i < kRT / 2; ++i) {
        const int r = rb + 2 * i;
        const int t = min((r0 + r) / p.group, p.sq - 1);
        const int qpos = kv_len - p.sq + t;
        const wg::RowLimits lim =
            wg::row_limits(p, lp, qpos, ib, kvh * p.group + (r0 + r) % p.group);
        float x = wg::score_options(p, sacc[i] * ksc[j], lim.slope, qpos, kcol);
        if (kcol >= kend || kcol < lim.lo || kcol > lim.hi) x = NEG_INF;
        ss[r * L::LDS + j] = x;
      }
    }
    __syncthreads();

    // online softmax, one warp a row, two keys a lane; P times the V scale
    for (int r = warp; r < kRT; r += kThreadsF32 / 32) {
      const float x0 = ss[r * L::LDS + lane], x1 = ss[r * L::LDS + lane + 32];
      float mx = fmaxf(x0, x1);
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      float sum = p0 + p1;
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ss[r * L::LDS + lane] = p0 * vsc[lane];
      ss[r * L::LDS + lane + 32] = p1 * vsc[lane + 32];
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // O += P V
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[c][i] *= c_s[orow0 + CPT * i];
#pragma unroll 4
    for (int j = 0; j < kTK; ++j) {
      const float v = vs[j * D + ocol];
      [[maybe_unused]] float v1 = 0.f;
      if constexpr (NC > 1) v1 = vs[j * D + ocol1];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float pij = ss[(orow0 + CPT * i) * L::LDS + j];
        acc[0][i] = fmaf(pij, v, acc[0][i]);
        if constexpr (NC > 1) acc[1][i] = fmaf(pij, v1, acc[1][i]);
      }
    }
  }
  __syncthreads();

  // O and LSE in the caller's layout: one split O (b, sq, h, d) f32 and LSE
  // (b, h, sq); more, f32 partials (splits, b, sq, h, d) and (splits, b, sq,
  // h). Rows that saw no key give O = 0 and LSE = -inf.
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = orow0 + CPT * i, gr = r0 + r;
    if (gr >= R) continue;
    const float l = l_s[r];
    const int t = gr / p.group, head = kvh * p.group + gr % p.group;
    size_t ri = (static_cast<size_t>(ib) * p.sq + t) * h + head;
    if (p.n_splits > 1) ri += static_cast<size_t>(split) * p.b * p.sq * h;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = ocol + c * kThreadsF32;
      if (col < p.d) static_cast<float*>(p.o)[ri * p.d + col] = l > 0.f ? acc[c][i] / l : 0.f;
    }
  }
  for (int r = tid; r < kRT; r += kThreadsF32) {
    const int gr = r0 + r;
    if (gr >= R) continue;
    const float l = l_s[r];
    const float lse = l > 0.f ? m_s[r] + logf(l) : -INFINITY;
    const int t = gr / p.group, head = kvh * p.group + gr % p.group;
    if (p.n_splits == 1)
      p.lse[(static_cast<size_t>(ib) * h + head) * p.sq + t] = lse;
    else
      p.lse[((static_cast<size_t>(split) * p.b + ib) * p.sq + t) * h + head] = lse;
  }
}

template <typename KV, int D>
cudaError_t launch(const void* k_pool, const void* v_pool, const wg::Params& prm,
                   cudaStream_t stream) {
  auto* kernel = &paged_f32_kernel<KV, D>;
  static cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::bytes);  // once
  if (err != cudaSuccess) return err;
  const int R = prm.group * prm.sq;
  dim3 grid((R + kRT - 1) / kRT, prm.b * prm.h_k, prm.n_splits);
  kernel<<<grid, kThreadsF32, Smem<D>::bytes, stream>>>(static_cast<const KV*>(k_pool),
                                                        static_cast<const KV*>(v_pool), prm);
  return cudaGetLastError();
}

template <typename KV>
cudaError_t launch_d(const void* kp, const void* vp, const wg::Params& prm, cudaStream_t stream) {
  return by_rung(prm.d, [&](auto rung) {
    return launch<KV, decltype(rung)::value>(kp, vp, prm, stream);
  });
}

template <typename KV, int D>
int blocks_per_sm() {
  int n = -1;
  auto* kernel = &paged_f32_kernel<KV, D>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Smem<D>::bytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreadsF32, Smem<D>::bytes) !=
          cudaSuccess)
    return -1;
  return n;
}

}  // namespace sim

}  // namespace

// This library's 16-bit query type: the source is built twice (_build.py),
// with XFA_HALF for the fp16 instantiations, without for the bf16 ones and
// the f32 kernel and the combine kernel, so that the halves compile in
// parallel.
#ifdef XFA_HALF
using T16 = __half;
constexpr int kT16 = XFA_F16;
#else
using T16 = __nv_bfloat16;
constexpr int kT16 = XFA_BF16;
#endif

// The (query dtype, pool dtype) pairs of this library's 16-bit kernels: T16
// queries over pools of T16, int8 or fp8. Calls f(T16{}, KV{}) for the pair
// (tags of the element types), or returns cudaErrorInvalidValue.
template <typename F>
cudaError_t by_dtypes(int q_dtype, int kv_dtype, F&& f) {
  if (q_dtype != kT16) return cudaErrorInvalidValue;
  switch (kv_dtype) {
    case XFA_I8:
      return f(T16{}, int8_t{});
    case XFA_FP8_E4M3:
      return f(T16{}, fp8e4m3_t{});
    default:
      return kv_dtype == kT16 ? f(T16{}, T16{}) : cudaErrorInvalidValue;
  }
}

// The head dims the kernels read: 1 <= d <= 256 with rows of whole 16-byte
// chunks (the tensor maps' strides, the uint4 and float4 loads): d % 16 == 0
// over int8 / fp8 pools, d % 8 over 16-bit pools, d % 4 for f32 queries over
// f32 pools. ops/paged.py::head_dim_align; other widths are padded by the
// wrapper (ops/paged.py::paged_attention_padded).
inline bool head_dim_ok(int d, int q_dtype, int kv_dtype) {
  const bool bytes = kv_dtype == XFA_I8 || kv_dtype == XFA_FP8_E4M3;
  const int align = bytes ? 16 : (q_dtype == XFA_F32 ? 4 : 8);
  return d >= 1 && d <= 256 && d % align == 0;
}

// q (b, sq, h_k * group, d) of q_dtype (bf16 or f16); pools (pages, h_k,
// page, d) of kv_dtype (q_dtype, int8 or fp8); scales (pages, h_k, page) f32
// or null; o_part (n_splits, b, h_k, group * sq, d) f32; lse_part (n_splits,
// b, h_k, group * sq) f32. d takes this library's rungs (by_rung), with
// head_dim_ok. row_tile (16 or 32) is the query rows per block,
// chosen by the caller (ops/paged.py). wl / wr: the window, < 0 unbounded
// (causal is wr = 0); softcap 0 is none; alibi (b, h_k * group) f32 and
// leftpad (b,) int32 may be null.
extern "C" int xfa_paged_attention(const void* q, int q_dtype, const void* k_pool,
                                   const void* v_pool, int kv_dtype, const void* k_scales,
                                   const void* v_scales, const void* block_tables,
                                   const void* kv_lens, void* o_part, void* lse_part, int b,
                                   int sq, int h_k, int group, int d, int page, int max_pages,
                                   int n_splits, int wl, int wr, float softcap,
                                   const void* alibi, const void* leftpad, int row_tile,
                                   void* stream) {
  if (b * sq == 0) return cudaSuccess;
  if (!head_dim_ok(d, q_dtype, kv_dtype)) return cudaErrorInvalidValue;
  const bool quant = kv_dtype == XFA_I8 || kv_dtype == XFA_FP8_E4M3;
  const Args a{q, k_pool, v_pool,
               quant ? static_cast<const float*>(k_scales) : nullptr,
               quant ? static_cast<const float*>(v_scales) : nullptr,
               static_cast<const int32_t*>(block_tables), static_cast<const int32_t*>(kv_lens),
               static_cast<float*>(o_part), static_cast<float*>(lse_part),
               static_cast<const float*>(alibi), static_cast<const int32_t*>(leftpad),
               b, sq, h_k, group, page, max_pages, n_splits, wl, wr, softcap, d};
  auto st = static_cast<cudaStream_t>(stream);
  return by_dtypes(q_dtype, kv_dtype, [&](auto t, auto kv) {
    return dispatch_d<decltype(t), decltype(kv)>(row_tile, a, st);
  });
}

namespace {

// The launch parameters of the Hopper, decode and f32 routes, or an error.
cudaError_t hopper_params(wg::Params* prm, const void* q, int q_dtype, int64_t q_sb,
                          int64_t q_st, int64_t q_sh, int kv_dtype, const void* k_scales,
                          const void* v_scales, const void* block_tables, const void* kv_lens,
                          void* o, void* lse, int b, int sq, int h_k, int group, int d, int page,
                          int max_pages, int pool_pages, int layer, int n_splits, int wl, int wr,
                          float scale, float softcap, const void* alibi, const void* leftpad) {
  const int box = wg::box_rows(page);
  if (page < 1 || n_splits < 1 || group < 1 || !head_dim_ok(d, q_dtype, kv_dtype))
    return cudaErrorInvalidValue;
  const bool quant = kv_dtype == XFA_I8 || kv_dtype == XFA_FP8_E4M3;
  if (quant && (k_scales == nullptr || v_scales == nullptr)) return cudaErrorInvalidValue;
  *prm = wg::Params{};
  prm->q = q;
  prm->q_sb = q_sb;
  prm->q_st = q_st;
  prm->q_sh = q_sh;
  prm->k_scales = quant ? static_cast<const float*>(k_scales) : nullptr;
  prm->v_scales = quant ? static_cast<const float*>(v_scales) : nullptr;
  prm->bt = static_cast<const int32_t*>(block_tables);
  prm->lens = static_cast<const int32_t*>(kv_lens);
  prm->o = o;
  prm->lse = static_cast<float*>(lse);
  prm->b = b;
  prm->sq = sq;
  prm->h_k = h_k;
  prm->group = group;
  prm->page = page;
  prm->max_pages = max_pages;
  prm->n_splits = n_splits;
  prm->n_rt = (group * sq + wg::kBQ - 1) / wg::kBQ;
  prm->d = d;
  prm->page0 = layer * pool_pages;
  prm->box_rows = box;
  prm->causal = wr == 0;
  prm->scale = scale;
  prm->wl = wl;
  prm->wr = wr;
  prm->softcap = softcap;
  prm->alibi = static_cast<const float*>(alibi);
  prm->leftpad = static_cast<const int32_t*>(leftpad);
  return cudaSuccess;
}

}  // namespace

// The Hopper route (ops/paged.py::paged_route): q (b, sq, h_k * group, d)
// of q_dtype (bf16 or f16) read through its (batch, token, head) element
// strides (last dimension contiguous, strides multiples of 8, base 16-byte
// aligned), not pre-scaled (the kernel multiplies it by `scale`); pools
// (n_layers, pool_pages, h_k, page, d) of kv_dtype (q_dtype, int8 or fp8)
// with page % 8 == 0, read at layer `layer`; d at this library's rungs
// (by_rung), with head_dim_ok; scales (n_layers, pool_pages,
// h_k, page) f32 or null (unquantized pools). The window (wl, wr) is counted
// from query position kv_len - sq + t, < 0 unbounded: causal is wr = 0;
// softcap 0 is none; alibi (b, h_k * group) f32 and leftpad (b,) int32 may
// be null. A window start, a right window > 0, a softcap, ALiBi or a leftpad
// take the kExtra instantiation. One split writes o (b, sq, h, d) of q_dtype
// and lse (b, h, sq); more write f32 partials o (n_splits, b, sq, h, d) and
// lse (n_splits, b, sq, h).
extern "C" int xfa_paged_attention_wgmma(const void* q, int q_dtype, int64_t q_sb, int64_t q_st,
                                         int64_t q_sh, const void* k_pool, const void* v_pool,
                                         int kv_dtype, const void* k_scales,
                                         const void* v_scales, const void* block_tables,
                                         const void* kv_lens, void* o, void* lse, int b, int sq,
                                         int h_k, int group, int d, int page, int max_pages,
                                         int n_layers, int pool_pages, int layer, int n_splits,
                                         int wl, int wr, float scale, float softcap,
                                         const void* alibi, const void* leftpad, void* stream) {
  if (b * sq == 0) return cudaSuccess;
  wg::Params prm;
  cudaError_t err = hopper_params(&prm, q, q_dtype, q_sb, q_st, q_sh, kv_dtype, k_scales,
                                  v_scales, block_tables, kv_lens, o, lse, b, sq, h_k, group, d,
                                  page, max_pages, pool_pages, layer, n_splits, wl, wr, scale,
                                  softcap, alibi, leftpad);
  if (err != cudaSuccess) return err;
  if (prm.box_rows == 0) return cudaErrorInvalidValue;
  const int n_pool_pages = n_layers * pool_pages;
  auto st = static_cast<cudaStream_t>(stream);
  return by_dtypes(q_dtype, kv_dtype, [&](auto t, auto kv) {
    return wg::launch_d<decltype(t), decltype(kv)>(k_pool, v_pool, n_pool_pages, prm, st);
  });
}

// The decode route (ops/paged.py::paged_route: sq * group <= 16 rows,
// page % 8 == 0): the arguments of xfa_paged_attention_wgmma. Each
// batch entry's live keys (from the tile of the first key any row can see)
// are cut into n_splits runs of whole 64-key tiles; splits past them write
// empty partials (O = 0, LSE = -inf).
extern "C" int xfa_paged_decode(const void* q, int q_dtype, int64_t q_sb, int64_t q_st,
                                int64_t q_sh, const void* k_pool, const void* v_pool,
                                int kv_dtype, const void* k_scales, const void* v_scales,
                                const void* block_tables, const void* kv_lens, void* o, void* lse,
                                int b, int sq, int h_k, int group, int d, int page, int max_pages,
                                int n_layers, int pool_pages, int layer, int n_splits, int wl,
                                int wr, float scale, float softcap, const void* alibi,
                                const void* leftpad, void* stream) {
  if (b * sq == 0) return cudaSuccess;
  wg::Params prm;
  cudaError_t err = hopper_params(&prm, q, q_dtype, q_sb, q_st, q_sh, kv_dtype, k_scales,
                                  v_scales, block_tables, kv_lens, o, lse, b, sq, h_k, group, d,
                                  page, max_pages, pool_pages, layer, n_splits, wl, wr, scale,
                                  softcap, alibi, leftpad);
  if (err != cudaSuccess) return err;
  if (prm.box_rows == 0) return cudaErrorInvalidValue;
  const int n_pool_pages = n_layers * pool_pages;
  auto st = static_cast<cudaStream_t>(stream);
  return by_dtypes(q_dtype, kv_dtype, [&](auto t, auto kv) {
    return dec::launch_rows<decltype(t), decltype(kv)>(k_pool, v_pool, n_pool_pages, prm, st);
  });
}

// The f32 route (ops/paged.py::paged_route: f32 queries, any page): the
// arguments of xfa_paged_attention_wgmma with q f32 (read through its strides,
// any alignment) over f32, int8 or fp8 pools, d at this library's rungs
// (head_dim_ok); the window,
// softcap, ALiBi and leftpad at run time. Each batch entry's live pages (from
// the page of the first key any row can see) are cut into n_splits runs; one
// split writes o (b, sq, h, d) f32 and lse (b, h, sq), more f32 partials
// (n_splits, b, sq, h, d) and (n_splits, b, sq, h) for xfa_paged_combine.
extern "C" int xfa_paged_f32(const void* q, int64_t q_sb, int64_t q_st, int64_t q_sh,
                             const void* k_pool, const void* v_pool, int kv_dtype,
                             const void* k_scales, const void* v_scales,
                             const void* block_tables, const void* kv_lens, void* o, void* lse,
                             int b, int sq, int h_k, int group, int d, int page, int max_pages,
                             int n_layers, int pool_pages, int layer, int n_splits, int wl,
                             int wr, float scale, float softcap, const void* alibi,
                             const void* leftpad, void* stream) {
#ifdef XFA_HALF
  return cudaErrorInvalidValue;  // built without XFA_HALF only
#else
  if (b * sq == 0) return cudaSuccess;
  (void)n_layers;
  wg::Params prm;
  cudaError_t err = hopper_params(&prm, q, XFA_F32, q_sb, q_st, q_sh, kv_dtype, k_scales,
                                  v_scales, block_tables, kv_lens, o, lse, b, sq, h_k, group, d,
                                  page, max_pages, pool_pages, layer, n_splits, wl, wr, scale,
                                  softcap, alibi, leftpad);
  if (err != cudaSuccess) return err;
  auto st = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case XFA_F32:
      return sim::launch_d<float>(k_pool, v_pool, prm, st);
    case XFA_I8:
      return sim::launch_d<int8_t>(k_pool, v_pool, prm, st);
    case XFA_FP8_E4M3:
      return sim::launch_d<fp8e4m3_t>(k_pool, v_pool, prm, st);
    default:
      return cudaErrorInvalidValue;
  }
#endif
}

namespace {

// resident blocks an SM of decode instantiation i = (the higher rung, rows > 8, options)
template <typename T, typename KV>
int decode_occupancy(int i) {
  constexpr int lo = kRungLo, hi = kRungHi;
  int (*const occ[8])() = {
      dec::blocks_per_sm<T, KV, lo, 1, false>, dec::blocks_per_sm<T, KV, lo, 1, true>,
      dec::blocks_per_sm<T, KV, lo, 2, false>, dec::blocks_per_sm<T, KV, lo, 2, true>,
      dec::blocks_per_sm<T, KV, hi, 1, false>, dec::blocks_per_sm<T, KV, hi, 1, true>,
      dec::blocks_per_sm<T, KV, hi, 2, false>, dec::blocks_per_sm<T, KV, hi, 2, true>};
  return occ[i]();
}

}  // namespace

// Resident blocks an SM of the decode kernel's (q_dtype, kv_dtype, d's rung,
// rows <= 8 or not, options or not) instantiation, by the CUDA occupancy
// calculator; -1 on an error or a rung this library does not hold.
// ops/paged.py's DECODE_BLOCKS must equal it (chip_smoke.py checks).
extern "C" int xfa_paged_decode_blocks_per_sm(int q_dtype, int kv_dtype, int d, int rows,
                                              int options) {
  const int rung = (d + 63) / 64 * 64;
  if (d < 1 || (rung != kRungLo && rung != kRungHi)) return -1;
  const int i = (rung == kRungHi) * 4 + (rows > 8) * 2 + (options != 0);
  int n = -1;
  by_dtypes(q_dtype, kv_dtype, [&](auto t, auto kv) {
    n = decode_occupancy<decltype(t), decltype(kv)>(i);
    return cudaSuccess;
  });
  return n;
}

// Resident blocks an SM of the f32 kernel over kv_dtype pools at d's rung,
// by the CUDA occupancy calculator; -1 on an error. ops/paged.py's
// F32_BLOCKS must equal it (chip_smoke.py checks). (Built without XFA_HALF.)
extern "C" int xfa_paged_f32_blocks_per_sm(int kv_dtype, int d) {
#ifdef XFA_HALF
  return -1;
#else
  const int rung = (d + 63) / 64 * 64;
  if (d < 1 || (rung != kRungLo && rung != kRungHi)) return -1;
  auto at = [&](auto kv) {
    using KV = decltype(kv);
    return rung == kRungHi ? sim::blocks_per_sm<KV, kRungHi>() : sim::blocks_per_sm<KV, kRungLo>();
  };
  switch (kv_dtype) {
    case XFA_F32:
      return at(float{});
    case XFA_I8:
      return at(int8_t{});
    case XFA_FP8_E4M3:
      return at(fp8e4m3_t{});
    default:
      return -1;
  }
#endif
}

// The merge of f32 split partials o_part (n_splits, b, sq, h, d) and
// lse_part (n_splits, b, sq, h) into o (b, sq, h, d) of out_dtype (bf16, f16
// or f32) and lse (b, h, sq): ops/paged.py::combine_splits_ref's arithmetic,
// at any head dim d, a multiple of 4 up to 256 (64 and 128 on kernels of
// their own). (Built without XFA_HALF and XFA_WIDE only.)
extern "C" int xfa_paged_combine(const void* o_part, const void* lse_part, void* o, void* lse,
                                 int out_dtype, int n_splits, int b, int sq, int h, int d,
                                 void* stream) {
#if defined(XFA_HALF) || defined(XFA_WIDE)
  return cudaErrorInvalidValue;
#else
  const int rows = b * sq * h;
  if (rows == 0) return cudaSuccess;
  if (n_splits < 1 || d < 1 || d > 256 || d % 4) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>((rows + 3) / 4);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* op = static_cast<const float*>(o_part);
  const auto* lp = static_cast<const float*>(lse_part);
  auto* lo = static_cast<float*>(lse);
  auto run = [&](auto tag) {
    using TO = decltype(tag);
    auto* oo = static_cast<TO*>(o);
    if (d == 128)
      dec::paged_combine_kernel<TO, 128><<<grid, 128, 0, st>>>(op, lp, oo, lo, n_splits, b, sq, h);
    else if (d == 64)
      dec::paged_combine_kernel<TO, 64><<<grid, 128, 0, st>>>(op, lp, oo, lo, n_splits, b, sq, h);
    else
      dec::paged_combine_kernel_any<TO>
          <<<grid, 128, 0, st>>>(op, lp, oo, lo, n_splits, b, sq, h, d);
    return cudaGetLastError();
  };
  switch (out_dtype) {
    case XFA_BF16:
      return run(__nv_bfloat16{});
    case XFA_F16:
      return run(__half{});
    case XFA_F32:
      return run(float{});
    default:
      return cudaErrorInvalidValue;
  }
#endif
}
