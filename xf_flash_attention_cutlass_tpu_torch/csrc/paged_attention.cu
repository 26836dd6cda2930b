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
// Three kernels, chosen by ops/paged.py::paged_route (a pure function of the
// shapes and the pool dtype; the options choose an instantiation, not a
// kernel):
//
// `paged_decode_kernel` (the decode route: at most 16 query rows a KV head,
// sq * group: decode and short verify; d 64 or 128, pages of a multiple of
// 8 keys, bf16 / int8 / fp8 pools). Decode is bound by bytes and by latency: a step reads
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
// an SM, one for int8 / fp8 pools at d = 128 (shared memory).
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
#include <string.h>

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

template <typename KV>
__device__ __forceinline__ void store_row16(__nv_bfloat16* dst, const uint4& raw) {
  // 16 bytes of KV values -> 16 / sizeof(KV) bf16 values at dst
  constexpr int E = 16 / sizeof(KV);
  const KV* v = reinterpret_cast<const KV*>(&raw);
#pragma unroll
  for (int e = 0; e < E; ++e) dst[e] = to_bf16(to_float(v[e]));
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
  __device__ __forceinline__ void load(const KV* k_pool, const KV* v_pool, const float* k_scales,
                                       const float* v_scales, const int32_t* bt_row, int k0,
                                       int kend, int kvh, int h_k, int page) {
    const size_t head_stride = static_cast<size_t>(page) * D;
#pragma unroll
    for (int it = 0; it < LOADS; ++it) {
      const int c = threadIdx.x + it * kThreads;
      const int kp = k0 + c / (D / CH), dc = (c % (D / CH)) * CH;
      k[it] = v[it] = make_uint4(0, 0, 0, 0);
      if (kp < kend) {
        const size_t off = (static_cast<size_t>(bt_row[kp / page]) * h_k + kvh) * head_stride +
                           static_cast<size_t>(kp % page) * D + dc;
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

  __device__ __forceinline__ void store(__nv_bfloat16* ks_smem, __nv_bfloat16* vs_smem,
                                        float* ksc, float* vsc, int ldq) const {
#pragma unroll
    for (int it = 0; it < LOADS; ++it) {
      const int c = threadIdx.x + it * kThreads;
      const int j = c / (D / CH), dc = (c % (D / CH)) * CH;
      store_row16<KV>(ks_smem + j * ldq + dc, k[it]);
      store_row16<KV>(vs_smem + j * ldq + dc, v[it]);
    }
    if (threadIdx.x < TK) {
      ksc[threadIdx.x] = ks;
      vsc[threadIdx.x] = vs;
    }
  }
};

template <typename KV, int D, int RT, bool kExtra>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const __nv_bfloat16* __restrict__ q,  // (b, sq, h, D), pre-scaled
    const KV* __restrict__ k_pool,        // (pages, h_k, page, D): one layer
    const KV* __restrict__ v_pool,
    const float* __restrict__ k_scales,  // (pages, h_k, page) or null
    const float* __restrict__ v_scales,
    const int32_t* __restrict__ block_tables,  // (b, max_pages)
    const int32_t* __restrict__ kv_lens,       // (b,)
    float* __restrict__ o_part,                // (splits, b, h_k, R, D)
    float* __restrict__ lse_part,              // (splits, b, h_k, R)
    const float* __restrict__ alibi,           // (b, h) or null
    const int32_t* __restrict__ leftpad,       // (b,) or null
    int b, int sq, int h_k, int group, int page, int max_pages, int wl, int wr,
    float softcap) {
  using L = Smem<D, RT>;
  constexpr int LDQ = L::LDQ, LDS = L::LDS, LDP = L::LDP, LDO = L::LDO;

  extern __shared__ __align__(128) unsigned char smem[];
  auto* qs = reinterpret_cast<__nv_bfloat16*>(smem + L::q);
  auto* ks = reinterpret_cast<__nv_bfloat16*>(smem + L::k);
  auto* vs = reinterpret_cast<__nv_bfloat16*>(smem + L::v);
  auto* ss = reinterpret_cast<float*>(smem + L::s);
  auto* ps = reinterpret_cast<__nv_bfloat16*>(smem + L::p);
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

  // Q tile (zeros past the last real row), stats and accumulator
  for (int c = threadIdx.x; c < RT * (D / 8); c += kThreads) {
    const int r = c / (D / 8), dc = (c % (D / 8)) * 8;
    const int gr = r0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (gr < R) {
      const int t = gr / group, gi = gr % group;
      val = *reinterpret_cast<const uint4*>(
          q + ((static_cast<size_t>(ib) * sq + t) * h + kvh * group + gi) * D + dc);
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
    regs.load(k_pool, v_pool, k_scales, v_scales, bt_row, kstart, kend, kvh, h_k, page);
  for (int k0 = kstart; k0 < kend; k0 += TK) {
    __syncthreads();  // previous tile fully consumed
    regs.store(ks, vs, ksc, vsc, LDQ);
    __syncthreads();
    if (k0 + TK < kend)  // in flight while this tile is computed
      regs.load(k_pool, v_pool, k_scales, v_scales, bt_row, k0 + TK, kend, kvh, h_k, page);

    // S = Q K^T on the tensor cores
    for (int f = warp; f < (RT / 16) * (TK / 16); f += kWarps) {
      const int fi = f / (TK / 16), fj = f % (TK / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bk;
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
        ps[r * LDP + c] = to_bf16(p * vsc[c]);
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
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bv;
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
    if (r0 + r >= R) continue;
    const float l = l_s[r];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    o_part[(base * R + r0 + r) * D + dcol] = os[r * LDO + dcol] * inv;
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
};

template <typename KV, int D, int RT, bool kExtra>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int smem = Smem<D, RT>::bytes;
  auto kernel = paged_attention_kernel<KV, D, RT, kExtra>;
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
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const KV*>(a.kp),
      static_cast<const KV*>(a.vp), a.ksc, a.vsc, a.bt, a.lens, a.o, a.lse, a.alibi, a.leftpad,
      a.b, a.sq, a.h_k, a.group, a.page, a.max_pages, a.wl, a.wr, a.softcap);
  return cudaGetLastError();
}

// The option-free kernel unless a window start, a right window beyond the
// causal one, softcap, ALiBi or leftpad asks for the general one.
template <typename KV, int D, int RT>
cudaError_t launch_x(const Args& a, cudaStream_t st) {
  const bool extra = a.wl >= 0 || a.wr > 0 || a.softcap > 0.f || a.alibi != nullptr ||
                     a.leftpad != nullptr;
  return extra ? launch<KV, D, RT, true>(a, st) : launch<KV, D, RT, false>(a, st);
}

template <typename KV>
cudaError_t dispatch_d(int d, int row_tile, const Args& a, cudaStream_t st) {
  if (row_tile != 16 && row_tile != 32) return cudaErrorInvalidValue;
  switch (d) {
    case 64:
      return row_tile == 16 ? launch_x<KV, 64, 16>(a, st) : launch_x<KV, 64, 32>(a, st);
    case 128:
      return row_tile == 16 ? launch_x<KV, 128, 16>(a, st) : launch_x<KV, 128, 32>(a, st);
    default:
      return cudaErrorInvalidValue;
  }
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
// (D / 2 f32).
constexpr int kProducerRegs = 56, kConsumerRegs = 200;
static_assert(2 * 128 * (kProducerRegs + kConsumerRegs) <= 65536, "register file");
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one block, from a 1024-byte aligned base: the Q tile and
// the ring of (K tile, V tile) stages, each tile D / 64 sub-tiles of 64 rows
// x 64 bf16 columns (128-byte swizzled); for int8 / fp8 pools the staging
// ring of (K bytes, V bytes) tiles (64 rows of D bytes, unswizzled) and each
// bf16 stage's 64 K and 64 V scales; then the barriers. Two blocks fit an SM
// except for int8 / fp8 pools at d = 128 (116.8 KB, one block).
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
  const __nv_bfloat16* q;    // (b, sq, h, D), not pre-scaled
  int64_t q_sb, q_st, q_sh;  // its (batch, token, head) strides in elements
  const float* k_scales;     // (L * pages, h_k, page) or null (bf16 pools)
  const float* v_scales;
  const int32_t* bt;    // (b, max_pages)
  const int32_t* lens;  // (b,)
  void* o;              // one split: (b, sq, h, D) bf16; more: (splits, b, sq, h, D) f32
  float* lse;           // one split: (b, h, sq); more: (splits, b, sq, h)
  int b, sq, h_k, group, page, max_pages, n_splits, n_rt;
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

// 16 pool bytes -> 16 bf16 values, as two 16-byte words in order
template <typename KV>
__device__ __forceinline__ void bytes_to_bf16(const uint4& raw, uint4& lo, uint4& hi) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t out[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = bf16x2_from_bytes02(KV{}, __byte_perm(w[i], 0, 0x4140));      // bytes 0, 1
    out[2 * i + 1] = bf16x2_from_bytes02(KV{}, __byte_perm(w[i], 0, 0x4342));  // bytes 2, 3
  }
  lo = make_uint4(out[0], out[1], out[2], out[3]);
  hi = make_uint4(out[4], out[5], out[6], out[7]);
}

// One staged byte tile (64 rows of D bytes) into a swizzled bf16 tile; rows
// from `live` on are written as zeros. pt: the thread of the producer
// warpgroup.
template <typename KV, int D>
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
    bytes_to_bf16<KV>(bytes, lo, hi);
    // 16-byte chunk c16 of row j of sub-tile dcol / 64 sits at chunk c16 ^ (j % 8)
    unsigned char* row = tile + (dcol / 64) * kBK * 128 + j * 128;
    const int c16 = (dcol % 64) / 8;
    *reinterpret_cast<uint4*>(row + ((c16 ^ (j & 7)) << 4)) = lo;
    *reinterpret_cast<uint4*>(row + (((c16 + 1) ^ (j & 7)) << 4)) = hi;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t r;
  memcpy(&r, &v, 4);
  return r;
}

// a bf16 pair times the softmax scale: f32 products rounded to bf16
__device__ __forceinline__ uint32_t scaled_pair(uint32_t w, float scale) {
  __nv_bfloat162 v;
  memcpy(&v, &w, 4);
  const float2 f = __bfloat1622float2(v);
  return pack_bf16(f.x * scale, f.y * scale);
}

template <typename KV, int D, bool kExtra>
__global__ void __launch_bounds__(kThreadsWg, 2)
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
        convert_tile<KV, D>(raw_k(rs), k_tile(st), live, pt);
        convert_tile<KV, D>(raw_v(rs), v_tile(st), live, pt);
        if (pt < kBK) {
          scales(st)[pt] = ks;
          scales(st)[kBK + pt] = vs;
        }
        fence_proxy_async();  // the bf16 tiles are read by wgmma (the async proxy)
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
  setmaxnreg_inc<kConsumerRegs>();
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int row = r0 + warp * 16 + (lane >> 2);
  const int col = (lane & 3) * 2;  // its key (and O) columns in an 8-column group

  // the Q tile times the softmax scale (f32 products rounded to bf16) into
  // shared memory, 128-byte swizzled as a TMA box would write it; rows past
  // R are zero. (With Q held as wgmma's A registers instead, ptxas gave
  // those registers to P at d = 64, measured on the card: the second key
  // tile's S read P.)
  for (int c = tid; c < kBQ * (D / 8); c += 128) {
    const int r = c / (D / 8), ch = c % (D / 8);  // row, 16-byte chunk
    const int gr = r0 + r;
    uint4 w = make_uint4(0, 0, 0, 0);
    if (gr < R) {
      const int t = gr / p.group, head = kvh * p.group + gr % p.group;
      w = *reinterpret_cast<const uint4*>(p.q + ib * p.q_sb + t * p.q_st + head * p.q_sh +
                                          ch * 8);
      w = make_uint4(scaled_pair(w.x, p.scale), scaled_pair(w.y, p.scale),
                     scaled_pair(w.z, p.scale), scaled_pair(w.w, p.scale));
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
      Wgmma<__nv_bfloat16, kBK>::ss(s, da, db, kk > 0);
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

    // O += P V: P times the V scale, rounded to bf16, packed as the A operand
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
        pa[kk][w] = pack_bf16(v0, v1);
      }
    }
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t db = desc_sw128(v_tile(st) + kk * 16 * 128, kBK * 128, 1024);
      Wgmma<__nv_bfloat16, D>::rs_tb(acc, pa[kk], db, 1);
    }
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
    if (p.n_splits == 1) {
      __nv_bfloat16* orow =
          static_cast<__nv_bfloat16*>(p.o) + ((static_cast<size_t>(ib) * p.sq + t) * h + head) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(orow + n * 8 + col) =
            pack_bf16(acc[4 * n + 2 * r] * inv, acc[4 * n + 2 * r + 1] * inv);
      if ((lane & 3) == 0) p.lse[(static_cast<size_t>(ib) * h + head) * p.sq + t] = lse;
    } else {
      const size_t ri = ((static_cast<size_t>(split) * p.b + ib) * p.sq + t) * h + head;
      float* orow = static_cast<float*>(p.o) + ri * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(orow + n * 8 + col) =
            make_float2(acc[4 * n + 2 * r] * inv, acc[4 * n + 2 * r + 1] * inv);
      if ((lane & 3) == 0) p.lse[ri] = lse;
    }
  }
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

template <typename KV, int D, bool kExtra>
cudaError_t launch(const void* k_pool, const void* v_pool, int n_pool_pages, const Params& prm,
                   cudaStream_t stream) {
  using L = Layout<KV, D>;
  constexpr uint64_t es = sizeof(KV);
  CUtensorMap maps[2];
  const void* bases[2] = {k_pool, v_pool};
  // (d, page, h_k, L * pages) over every layer: the layer is a page coordinate
  const uint64_t dims[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(prm.page),
                            static_cast<uint64_t>(prm.h_k), static_cast<uint64_t>(n_pool_pages)};
  const uint64_t strides[3] = {D * es, static_cast<uint64_t>(prm.page) * D * es,
                               static_cast<uint64_t>(prm.h_k) * prm.page * D * es};
  // byte pools: boxes of whole D-byte rows, unswizzled (staged); bf16 pools:
  // 64-column boxes, 128-byte swizzled (the ring wgmma reads)
  const uint32_t box[4] = {L::kQuant ? static_cast<uint32_t>(D) : 64u,
                           static_cast<uint32_t>(prm.box_rows), 1, 1};
  for (int i = 0; i < 2; ++i) {
    cudaError_t err =
        L::kQuant ? make_map(&maps[i], CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, bases[i], dims, strides,
                             box, CU_TENSOR_MAP_SWIZZLE_NONE)
                  : make_map(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, bases[i], dims,
                             strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return err;
  }
  auto* kernel = &paged_wgmma_kernel<KV, D, kExtra>;
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

template <typename KV, bool kExtra>
cudaError_t launch_x(int d, const void* kp, const void* vp, int n_pool_pages, const Params& prm,
                     cudaStream_t stream) {
  if (d == 128) return launch<KV, 128, kExtra>(kp, vp, n_pool_pages, prm, stream);
  if (d == 64) return launch<KV, 64, kExtra>(kp, vp, n_pool_pages, prm, stream);
  return cudaErrorInvalidValue;
}

template <typename KV>
cudaError_t launch_d(int d, const void* kp, const void* vp, int n_pool_pages, const Params& prm,
                     cudaStream_t stream) {
  return has_options(prm) ? launch_x<KV, true>(d, kp, vp, n_pool_pages, prm, stream)
                          : launch_x<KV, false>(d, kp, vp, n_pool_pages, prm, stream);
}

}  // namespace wg

// ---- the decode route: paged_decode_kernel and paged_combine_kernel -------------

namespace dec {

using namespace hopper;
using wg::pack_bf16;

constexpr int kTK = 64;     // keys per tile
constexpr int kWarps = 4;   // consumer warps: 16 keys of every tile each
constexpr int kThreadsDec = 32 * kWarps + 32;  // the consumers, then the producer warp
constexpr int kBlocksPerSm = 2;  // ops/paged.py's DECODE_BLOCKS_PER_SM
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one block, from a 1024-byte aligned base: the ring of
// (K tile, V tile) stages as the pool stores them (64 key rows of D values
// each, raw bytes for int8 / fp8), each tile kSub sub-tiles of 64 rows x kW
// bytes (kW = 128: the 128-byte swizzle; 64 for 64-byte rows: the 64-byte
// swizzle), then each stage's 64 K and 64 V scales (int8 / fp8), then the
// barriers. The ring takes as many stages as half of an SM's 228 KB holds
// (3 to 13), so that exactly two blocks are resident whatever the
// instantiation (the split heuristic counts them) and a long split keeps
// that many tiles in flight. After the loop the ring holds the warps' merge.
template <typename KV, int D>
struct Layout {
  static constexpr bool kQuant = sizeof(KV) == 1;
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(KV));
  static constexpr int kW = kRowBytes >= 128 ? 128 : 64;
  static constexpr int kSub = kRowBytes / kW;
  static constexpr int kTileBytes = kTK * kRowBytes;
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kSmSmem = 233472;  // an SM's shared memory, 1 KB a block reserved
  static constexpr int kStages =
      (kSmSmem / kBlocksPerSm - 2048) / (kStageBytes + (kQuant ? 2 * kTK * 4 : 0) + 16);
  static constexpr int kScaleOffset = kStages * kStageBytes;
  static constexpr int kBarOffset = kScaleOffset + (kQuant ? kStages * 2 * kTK * 4 : 0);
  static constexpr int kBytes = kBarOffset + 8 * 2 * kStages + 1024;  // + alignment
  static constexpr int kLdr = D + 8;  // f32 row of the merge buffer
  static_assert(kWarps * 16 * kLdr * 4 + 2 * kWarps * 16 * 4 <= kScaleOffset, "merge in ring");
  static_assert(kBlocksPerSm * (kBytes + 1024) <= kSmSmem &&
                    (kBlocksPerSm + 1) * (kBytes + 1024) > kSmSmem,
                "exactly two blocks an SM");
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

template <typename KV>
__device__ __forceinline__ uint32_t lo02(uint32_t w) { return bf16x2_from_bytes02(KV{}, w); }
template <typename KV>
__device__ __forceinline__ uint32_t hi13(uint32_t w) { return bf16x2_from_bytes02(KV{}, w >> 8); }

// q[i] times the softmax scale, f32 product rounded to bf16
__device__ __forceinline__ float scaled(const __nv_bfloat16* q, int i, float scale) {
  return __bfloat162float(q[i]) * scale;
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
template <typename KV, int D, int NT, bool kExtra>
__global__ void __launch_bounds__(kThreadsDec, kBlocksPerSm)
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

  // Q's B fragments, times the softmax scale (f32 products rounded to bf16):
  // k-step kk of bf16 K reads d 16kk + 2c, +1 and 16kk + 8 + 2c, +1; of
  // byte K, d 16kk + 4c, +2 and 16kk + 4c + 1, +3. Rows past R are zero.
  uint32_t qb[kMT][NT][2];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int r = 8 * n + g;
    const __nv_bfloat16* qrow = nullptr;
    if (r < R)
      qrow = p.q + ib * p.q_sb + (r / p.group) * p.q_st + (kvh * p.group + r % p.group) * p.q_sh;
#pragma unroll
    for (int kk = 0; kk < kMT; ++kk) {
      if (qrow == nullptr) {
        qb[kk][n][0] = qb[kk][n][1] = 0u;
      } else if constexpr (kQuant) {
        const int e = 16 * kk + 4 * c;
        qb[kk][n][0] = pack_bf16(scaled(qrow, e, p.scale), scaled(qrow, e + 2, p.scale));
        qb[kk][n][1] = pack_bf16(scaled(qrow, e + 1, p.scale), scaled(qrow, e + 3, p.scale));
      } else {
        const int e = 16 * kk + 2 * c;
        qb[kk][n][0] = pack_bf16(scaled(qrow, e, p.scale), scaled(qrow, e + 1, p.scale));
        qb[kk][n][1] = pack_bf16(scaled(qrow, e + 8, p.scale), scaled(qrow, e + 9, p.scale));
      }
    }
  }
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
        const uint32_t a0[4] = {lo02<KV>(r[0]), lo02<KV>(r[1]), hi13<KV>(r[0]), hi13<KV>(r[1])};
        const uint32_t a1[4] = {lo02<KV>(r[2]), lo02<KV>(r[3]), hi13<KV>(r[2]), hi13<KV>(r[3])};
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          mma_bf16_16816(s[n], a0, qb[2 * kx][n]);
          mma_bf16_16816(s[n], a1, qb[2 * kx + 1][n]);
        }
      } else {
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_bf16_16816(s[n], r, qb[kx][n]);
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
    // kend, where the scale was not loaded), rounded to bf16, as P^T's B
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
      pb[n][0] = movmatrix_trans(pack_bf16(pv[0], pv[1]));
      pb[n][1] = movmatrix_trans(pack_bf16(pv[2], pv[3]));
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
        const uint32_t a0[4] = {lo02<KV>(r[0]), lo02<KV>(r[1]), lo02<KV>(r[2]), lo02<KV>(r[3])};
        const uint32_t a1[4] = {hi13<KV>(r[0]), hi13<KV>(r[1]), hi13<KV>(r[2]), hi13<KV>(r[3])};
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          mma_bf16_16816(acc[2 * q2][n], a0, pb[n]);
          mma_bf16_16816(acc[2 * q2 + 1][n], a1, pb[n]);
        }
      } else {
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_bf16_16816(acc[q2][n], r, pb[n]);
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
  // (b, sq, h, D) bf16 and LSE (b, h, sq); more write f32 partials
  // (splits, b, sq, h, D) and (splits, b, sq, h). Rows that saw no key give
  // O = 0 and LSE = -inf.
  const int tid = threadIdx.x;
  for (int x = tid; x < R * (D / 4); x += 32 * kWarps) {
    const int row = x / (D / 4), d4 = (x % (D / 4)) * 4;
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
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p.o) + ri * D + d4) =
          make_uint2(pack_bf16(o.x, o.y), pack_bf16(o.z, o.w));
    } else {
      const size_t pi = static_cast<size_t>(split) * p.b * p.sq * h + ri;
      *reinterpret_cast<float4*>(static_cast<float*>(p.o) + pi * D + d4) = o;
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

template <typename KV, int D, int NT, bool kExtra>
cudaError_t prepare() {
  // raise the dynamic shared-memory limit once per instantiation (one device)
  static cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<KV, D, NT, kExtra>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                Layout<KV, D>::kBytes);
  return err;
}

template <typename KV, int D, int NT, bool kExtra>
cudaError_t launch(const void* k_pool, const void* v_pool, int n_pool_pages,
                   const wg::Params& prm, cudaStream_t stream) {
  using L = Layout<KV, D>;
  constexpr uint64_t es = sizeof(KV);
  CUtensorMap maps[2];
  const void* bases[2] = {k_pool, v_pool};
  // (d, page, h_k, L * pages) over every layer: the layer is a page coordinate
  const uint64_t dims[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(prm.page),
                            static_cast<uint64_t>(prm.h_k), static_cast<uint64_t>(n_pool_pages)};
  const uint64_t strides[3] = {D * es, static_cast<uint64_t>(prm.page) * D * es,
                               static_cast<uint64_t>(prm.h_k) * prm.page * D * es};
  const uint32_t box[4] = {static_cast<uint32_t>(L::kW / es),
                           static_cast<uint32_t>(prm.box_rows), 1, 1};
  const CUtensorMapSwizzle swizzle =
      L::kW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  for (int i = 0; i < 2; ++i) {
    cudaError_t err = make_map(
        &maps[i], L::kQuant ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
        4, bases[i], dims, strides, box, swizzle);
    if (err != cudaSuccess) return err;
  }
  cudaError_t err = prepare<KV, D, NT, kExtra>();
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>(prm.n_splits) * prm.b * prm.h_k;
  paged_decode_kernel<KV, D, NT, kExtra>
      <<<grid, kThreadsDec, L::kBytes, stream>>>(maps[0], maps[1], prm);
  return cudaGetLastError();
}

template <typename KV, int NT, bool kExtra>
cudaError_t launch_d(int d, const void* kp, const void* vp, int n_pool_pages,
                     const wg::Params& prm, cudaStream_t stream) {
  if (d == 128) return dec::launch<KV, 128, NT, kExtra>(kp, vp, n_pool_pages, prm, stream);
  if (d == 64) return dec::launch<KV, 64, NT, kExtra>(kp, vp, n_pool_pages, prm, stream);
  return cudaErrorInvalidValue;
}

template <typename KV, bool kExtra>
cudaError_t launch_x(int d, const void* kp, const void* vp, int n_pool_pages,
                     const wg::Params& prm, cudaStream_t stream) {
  return prm.sq * prm.group <= 8
             ? dec::launch_d<KV, 1, kExtra>(d, kp, vp, n_pool_pages, prm, stream)
             : dec::launch_d<KV, 2, kExtra>(d, kp, vp, n_pool_pages, prm, stream);
}

template <typename KV>
cudaError_t launch_rows(int d, const void* kp, const void* vp, int n_pool_pages,
                        const wg::Params& prm, cudaStream_t stream) {
  if (prm.sq * prm.group > 16) return cudaErrorInvalidValue;
  return wg::has_options(prm) ? dec::launch_x<KV, true>(d, kp, vp, n_pool_pages, prm, stream)
                              : dec::launch_x<KV, false>(d, kp, vp, n_pool_pages, prm, stream);
}

template <typename KV, int D, int NT, bool kExtra>
int blocks_per_sm() {
  int n = -1;
  if (prepare<KV, D, NT, kExtra>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, paged_decode_kernel<KV, D, NT, kExtra>,
                                                    kThreadsDec, Layout<KV, D>::kBytes) !=
          cudaSuccess)
    return -1;
  return n;
}

// The merge of split partials: one warp per (batch entry, token, head) row,
// the splits' weights exp(LSE_s - max) in split order, O in bf16.
template <int D>
__global__ void __launch_bounds__(128) paged_combine_kernel(
    const float* __restrict__ o_part,    // (splits, b, sq, h, D)
    const float* __restrict__ lse_part,  // (splits, b, sq, h)
    __nv_bfloat16* __restrict__ o,       // (b, sq, h, D)
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
  __nv_bfloat16* dst = o + static_cast<size_t>(r) * D + lane * V;
#pragma unroll
  for (int j = 0; j < V; j += 2)
    *reinterpret_cast<uint32_t*>(dst + j) = pack_bf16(acc[j] * inv, acc[j + 1] * inv);
  if (lane == 0) {
    const int head = r % h, t = r / h % sq, ib = r / (h * sq);
    lse[(static_cast<size_t>(ib) * h + head) * sq + t] = has ? m_safe + logf(sumw) : -INFINITY;
  }
}

}  // namespace dec

}  // namespace

// q (b, sq, h_k * group, d) bf16; pools (pages, h_k, page, d) of kv_dtype;
// scales (pages, h_k, page) f32 or null; o_part (n_splits, b, h_k, group *
// sq, d) f32; lse_part (n_splits, b, h_k, group * sq) f32. row_tile (16 or
// 32) is the query rows per block, chosen by the caller (ops/paged.py).
// wl / wr: the window, < 0 unbounded (causal is wr = 0); softcap 0 is none;
// alibi (b, h_k * group) f32 and leftpad (b,) int32 may be null.
extern "C" int xfa_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                                   int kv_dtype, const void* k_scales, const void* v_scales,
                                   const void* block_tables, const void* kv_lens, void* o_part,
                                   void* lse_part, int b, int sq, int h_k, int group, int d,
                                   int page, int max_pages, int n_splits, int wl, int wr,
                                   float softcap, const void* alibi, const void* leftpad,
                                   int row_tile, void* stream) {
  if (b * sq == 0) return cudaSuccess;
  const bool quant = kv_dtype != XFA_BF16;
  const Args a{q, k_pool, v_pool,
               quant ? static_cast<const float*>(k_scales) : nullptr,
               quant ? static_cast<const float*>(v_scales) : nullptr,
               static_cast<const int32_t*>(block_tables), static_cast<const int32_t*>(kv_lens),
               static_cast<float*>(o_part), static_cast<float*>(lse_part),
               static_cast<const float*>(alibi), static_cast<const int32_t*>(leftpad),
               b, sq, h_k, group, page, max_pages, n_splits, wl, wr, softcap};
  auto st = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case XFA_BF16:
      return dispatch_d<__nv_bfloat16>(d, row_tile, a, st);
    case XFA_I8:
      return dispatch_d<int8_t>(d, row_tile, a, st);
    case XFA_FP8_E4M3:
      return dispatch_d<fp8e4m3_t>(d, row_tile, a, st);
    default:
      return cudaErrorInvalidValue;
  }
}

namespace {

// The launch parameters of the Hopper and decode routes, or an error.
cudaError_t hopper_params(wg::Params* prm, const void* q, int64_t q_sb, int64_t q_st,
                          int64_t q_sh, int kv_dtype, const void* k_scales, const void* v_scales,
                          const void* block_tables, const void* kv_lens, void* o, void* lse,
                          int b, int sq, int h_k, int group, int page, int max_pages,
                          int pool_pages, int layer, int n_splits, int wl, int wr, float scale,
                          float softcap, const void* alibi, const void* leftpad) {
  const int box = wg::box_rows(page);
  if (box == 0 || n_splits < 1 || group < 1) return cudaErrorInvalidValue;
  const bool quant = kv_dtype != XFA_BF16;
  if (quant && (k_scales == nullptr || v_scales == nullptr)) return cudaErrorInvalidValue;
  *prm = wg::Params{};
  prm->q = static_cast<const __nv_bfloat16*>(q);
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
// bf16 read through its (batch, token, head) element strides (last dimension
// contiguous, strides multiples of 8, base 16-byte aligned), not pre-scaled
// (the kernel multiplies it by `scale`); pools (n_layers, pool_pages, h_k,
// page, d) of kv_dtype with page % 8 == 0, read at layer `layer`; scales
// (n_layers, pool_pages, h_k, page) f32 or null (bf16 pools). The window
// (wl, wr) is counted from query position kv_len - sq + t, < 0 unbounded:
// causal is wr = 0; softcap 0 is none; alibi (b, h_k * group) f32 and
// leftpad (b,) int32 may be null. A window start, a right window > 0, a
// softcap, ALiBi or a leftpad take the kExtra instantiation.
// One split writes o (b, sq, h, d) bf16 and lse (b, h, sq); more write f32
// partials o (n_splits, b, sq, h, d) and lse (n_splits, b, sq, h).
extern "C" int xfa_paged_attention_wgmma(const void* q, int64_t q_sb, int64_t q_st,
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
  cudaError_t err = hopper_params(&prm, q, q_sb, q_st, q_sh, kv_dtype, k_scales, v_scales,
                                  block_tables, kv_lens, o, lse, b, sq, h_k, group, page,
                                  max_pages, pool_pages, layer, n_splits, wl, wr, scale, softcap,
                                  alibi, leftpad);
  if (err != cudaSuccess) return err;
  const int n_pool_pages = n_layers * pool_pages;
  auto st = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case XFA_BF16:
      return wg::launch_d<__nv_bfloat16>(d, k_pool, v_pool, n_pool_pages, prm, st);
    case XFA_I8:
      return wg::launch_d<int8_t>(d, k_pool, v_pool, n_pool_pages, prm, st);
    case XFA_FP8_E4M3:
      return wg::launch_d<fp8e4m3_t>(d, k_pool, v_pool, n_pool_pages, prm, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// The decode route (ops/paged.py::paged_route: sq * group <= 16 rows, d 64
// or 128, page % 8 == 0): the arguments of xfa_paged_attention_wgmma. Each
// batch entry's live keys (from the tile of the first key any row can see)
// are cut into n_splits runs of whole 64-key tiles; splits past them write
// empty partials (O = 0, LSE = -inf).
extern "C" int xfa_paged_decode(const void* q, int64_t q_sb, int64_t q_st, int64_t q_sh,
                                const void* k_pool, const void* v_pool, int kv_dtype,
                                const void* k_scales, const void* v_scales,
                                const void* block_tables, const void* kv_lens, void* o, void* lse,
                                int b, int sq, int h_k, int group, int d, int page, int max_pages,
                                int n_layers, int pool_pages, int layer, int n_splits, int wl,
                                int wr, float scale, float softcap, const void* alibi,
                                const void* leftpad, void* stream) {
  if (b * sq == 0) return cudaSuccess;
  wg::Params prm;
  cudaError_t err = hopper_params(&prm, q, q_sb, q_st, q_sh, kv_dtype, k_scales, v_scales,
                                  block_tables, kv_lens, o, lse, b, sq, h_k, group, page,
                                  max_pages, pool_pages, layer, n_splits, wl, wr, scale, softcap,
                                  alibi, leftpad);
  if (err != cudaSuccess) return err;
  const int n_pool_pages = n_layers * pool_pages;
  auto st = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case XFA_BF16:
      return dec::launch_rows<__nv_bfloat16>(d, k_pool, v_pool, n_pool_pages, prm, st);
    case XFA_I8:
      return dec::launch_rows<int8_t>(d, k_pool, v_pool, n_pool_pages, prm, st);
    case XFA_FP8_E4M3:
      return dec::launch_rows<fp8e4m3_t>(d, k_pool, v_pool, n_pool_pages, prm, st);
    default:
      return cudaErrorInvalidValue;
  }
}

namespace {

// resident blocks an SM of decode instantiation i = (d == 128, rows > 8, options)
template <typename KV>
int decode_occupancy(int i) {
  int (*const occ[8])() = {
      dec::blocks_per_sm<KV, 64, 1, false>,  dec::blocks_per_sm<KV, 64, 1, true>,
      dec::blocks_per_sm<KV, 64, 2, false>,  dec::blocks_per_sm<KV, 64, 2, true>,
      dec::blocks_per_sm<KV, 128, 1, false>, dec::blocks_per_sm<KV, 128, 1, true>,
      dec::blocks_per_sm<KV, 128, 2, false>, dec::blocks_per_sm<KV, 128, 2, true>};
  return occ[i]();
}

}  // namespace

// Resident blocks an SM of the decode kernel's (kv_dtype, d, rows <= 8 or
// not, options or not) instantiation, by the CUDA occupancy calculator; -1
// on an error. ops/paged.py's DECODE_BLOCKS_PER_SM must equal it
// (chip_smoke.py checks).
extern "C" int xfa_paged_decode_blocks_per_sm(int kv_dtype, int d, int rows, int options) {
  if (d != 64 && d != 128) return -1;
  const int i = (d == 128) * 4 + (rows > 8) * 2 + (options != 0);
  switch (kv_dtype) {
    case XFA_BF16:
      return decode_occupancy<__nv_bfloat16>(i);
    case XFA_I8:
      return decode_occupancy<int8_t>(i);
    case XFA_FP8_E4M3:
      return decode_occupancy<fp8e4m3_t>(i);
    default:
      return -1;
  }
}

// The merge of f32 split partials o_part (n_splits, b, sq, h, d) and
// lse_part (n_splits, b, sq, h) into o (b, sq, h, d) bf16 and lse (b, h, sq):
// ops/paged.py::combine_splits_ref's arithmetic.
extern "C" int xfa_paged_combine(const void* o_part, const void* lse_part, void* o, void* lse,
                                 int n_splits, int b, int sq, int h, int d, void* stream) {
  const int rows = b * sq * h;
  if (rows == 0) return cudaSuccess;
  if (n_splits < 1) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>((rows + 3) / 4);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* op = static_cast<const float*>(o_part);
  const auto* lp = static_cast<const float*>(lse_part);
  auto* oo = static_cast<__nv_bfloat16*>(o);
  auto* lo = static_cast<float*>(lse);
  if (d == 128)
    dec::paged_combine_kernel<128><<<grid, 128, 0, st>>>(op, lp, oo, lo, n_splits, b, sq, h);
  else if (d == 64)
    dec::paged_combine_kernel<64><<<grid, 128, 0, st>>>(op, lp, oo, lo, n_splits, b, sq, h);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
