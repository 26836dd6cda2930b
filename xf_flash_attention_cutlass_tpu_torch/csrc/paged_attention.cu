// Paged split-KV attention over a block-table KV pool (K1).
//
// Replaces the TPU kernel xf_flash_attention_cutlass_tpu/ops/paged.py
// `_paged_kernel` (:97, launched at :745): attention of new query tokens over
// the pages of a block table, causal from the bottom right (query token t of
// sq sits at position kv_len - sq + t), int8 / fp8-e4m3 / bf16 pools with the
// per-token K scale on the score plane and the V scale on P, split-KV f32
// partials (O, LSE) with LSE = -inf for rows that saw no key. The partials
// are merged by combine_partials in plain torch, as on the TPU.
//
// Bound on an H100 (3.35 TB/s, 989 TFLOP/s bf16): decode (sq = 1, b = 8,
// Llama-8B GQA 32/8 heads, d = 128, fp8 pools) reads each live key and
// value byte once and does 4 * group = 16 flops per K/V byte pair, far
// below the ~295 flops per byte the card needs to be compute bound: bytes
// bound. A 256-token prefill chunk does 4 * 256 * group flops per key:
// operations bound (tensor cores).
// Design: one block per (row tile, batch entry, KV head, split). A row tile
// holds RT query rows of ONE KV head, ordered token-major with the GQA group
// inside (row = t * group + g), so every K/V tile fetched is used by all
// heads of its group. Each batch entry's LIVE pages are cut into n_splits
// equal runs, so every split of a row has work whatever the table width.
// The block walks the keys of its split in tiles of 64: each key's page
// comes from the block table, the next tile's K, V and scales are loaded
// into registers while the current tile is computed (one tile of
// prefetch), K and V are converted to bf16 in shared memory (exact for
// int8 and e4m3), S = Q K^T
// and O += P V run on the tensor cores (WMMA, f32 accumulate), and an online
// softmax in f32 keeps the running max m, the sum l and the accumulator O
// in shared memory. As on the TPU the softmax scale is folded into q by the
// wrapper, and P is rounded to bf16 (q's dtype) after the V scale and before
// the PV product. Keys past the causal limit, the split or kv_len are never
// loaded. Rows with kv_len = 0 (inactive slots) give O = 0 and LSE = -inf.
//
// The kExtra instantiation adds what the API passes (the option-free one is
// the serving path's, unchanged): a window (wl, wr) from query position
// kv_len - sq + t, non-causal included; the tanh softcap on the K-scaled
// score; ALiBi, the score of row t * group + g losing slope[b, kv_head * group
// + g] * |qpos - kcol| after the softcap, distances counted from the leftpad;
// and cache_leftpad, which masks the keys before it. As the TPU kernel folds
// the window start into its loop bound, the pages before the first key any
// row can see (window start, leftpad) are left out of the split runs, and a
// block starts at its first row's earliest key, so they are never loaded.
#include <mma.h>

#include "common.cuh"

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
          x -= slope * fabsf(static_cast<float>((qpos - lp) - (kcol - lp)));
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
