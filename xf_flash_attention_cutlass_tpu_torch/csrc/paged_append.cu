// In-place paged KV append with per-token quantization (K2, K5 and K6).
//
// Replaces the TPU kernels xf_flash_attention_cutlass_tpu/ops/paged_append.py
// `_decode_append_kernel` (:68, one token per row at any position),
// `_prefill_append_kernel` (:166, a chunk of tokens at window-aligned
// positions) and `_scale_write_kernel` (:275, whole per-page scale planes of
// quantized prefill into small pages). On a GPU the TPU's tile-aligned
// window read-modify-write and its alignment rules do not apply, and the
// port's pools keep one scale per row: one kernel serves decode (sq = 1),
// verify-style (sq > 1 at any position) and chunked or bucketed prefill
// alike, writing pool[bt[b, pos / page], h, pos % page, :] in place and
// skipping rows past the block table. The rows are bf16, f16 or f32 (the
// model's dtype; one instantiation each), written as they are into pools of
// their own type or quantized into int8 / fp8 pools.
//
// Bound on an H100 (3.35 TB/s): bytes. Each (token, kv head, K|V) row reads
// d values of the rows' type once and writes d values of the pool's type and
// one f32 scale: a 2048-token bucket of Llama-8B (8 kv heads, d = 128, fp8) moves
// 12.7 MB, a 3.8 us bound; decode (8 tokens) moves 48 KB, far under the
// launch's own cost.
// Design: a group of lanes owns a row, with no block barrier. At d = 128 a
// warp takes a row and each lane 4 elements: one 8-byte load (16 for f32
// rows), an exact max by __shfl_xor within the group, 4 IEEE divisions and
// one packed 4-byte store (unquantized pools: the bytes as loaded); at
// d <= 64 a half-warp takes a row. Wider or narrower rows run the same code as a strided loop over
// 4-element chunks (the first chunk kept in registers, the others read
// again for the second pass); rows whose bytes are not chunk multiples, or
// operands not aligned for the vector accesses, take element-wise loads and
// stores (kVec = false). A row's first chunk is loaded before its position
// and block-table entry, which lane r of the group reads for row r and
// broadcasts; lane 0 writes the scale. Blocks hold consecutive rows of the
// same K or V tensor. When the rows still give every SM a block of 256
// threads at 4 rows a group (a 2048-token bucket: 32768 rows, 1024 blocks),
// a group takes 4 rows and has their loads in flight together; otherwise a
// group takes one row, in blocks of 32-256 threads, the largest that still
// gives every SM a block (decode at b = 8: 128 rows, 128 one-warp blocks).
//
// Quantization is bit-exact with the pools the JAX package writes (see the
// port's quant/kv.py):
//   scale = amax * (1 / qmax) in float32 (1 when amax == 0) — the form XLA
//   compiles the reference's amax / qmax to — and y = x / scale (IEEE),
//   int8: rintf (half to even), clip to +-127; fp8-e4m3: clip to +-448, then
//   round-to-nearest-even with saturation, one value at a time. Every
//   bf16 and f16 value is an f32 value, so the row's f32 values (and so the
//   amax, the scale and every quotient) are those of the plain version for
//   every row type, f32 rows with their full mantissa.
// Built without --use_fast_math so that the division and rintf stay IEEE.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kSms = 132;  // an H100's SMs

// The 4-element chunk at i of a row of d TIn values (bf16, f16 or f32) as
// raw bits: 8 bytes for the 16-bit types, 16 for f32; one vector load, or
// element-wise with the values past d as 0.
template <typename TIn>
using Chunk = std::conditional_t<sizeof(TIn) == 4, uint4, uint2>;

template <typename TIn, bool kVec>
__device__ __forceinline__ Chunk<TIn> load_chunk(const TIn* src, int i, int d) {
  if constexpr (kVec) {
    return *reinterpret_cast<const Chunk<TIn>*>(src + i);
  } else if constexpr (sizeof(TIn) == 4) {
    uint32_t h[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) h[e] = i + e < d ? __float_as_uint(src[i + e]) : 0u;
    return make_uint4(h[0], h[1], h[2], h[3]);
  } else {
    const auto* raw = reinterpret_cast<const uint16_t*>(src);
    uint32_t h[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) h[e] = i + e < d ? raw[i + e] : 0u;
    return make_uint2(h[0] | (h[1] << 16), h[2] | (h[3] << 16));
  }
}

// the chunk's four values as floats (exact for every input type)
template <typename TIn>
__device__ __forceinline__ void chunk_floats(const Chunk<TIn>& w, float (&x)[4]) {
  if constexpr (sizeof(TIn) == 4) {
    x[0] = __uint_as_float(w.x);
    x[1] = __uint_as_float(w.y);
    x[2] = __uint_as_float(w.z);
    x[3] = __uint_as_float(w.w);
  } else {
    const float2 a = unpack2<TIn>(w.x), b = unpack2<TIn>(w.y);
    x[0] = a.x;
    x[1] = a.y;
    x[2] = b.x;
    x[3] = b.y;
  }
}

template <typename TIn>
__device__ __forceinline__ float chunk_amax(const Chunk<TIn>& w) {
  float x[4];
  chunk_floats<TIn>(w, x);
  return fmaxf(fmaxf(fabsf(x[0]), fabsf(x[1])), fmaxf(fabsf(x[2]), fabsf(x[3])));
}

__device__ __forceinline__ uint32_t quant_byte(int8_t, float y) {
  const float r = fminf(fmaxf(rintf(y), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int8_t>(r)) & 0xFFu;
}

__device__ __forceinline__ uint32_t quant_byte(fp8e4m3_t, float y) {
  const float c = fminf(fmaxf(y, -448.f), 448.f);
  return static_cast<uint32_t>(__nv_cvt_float_to_fp8(c, __NV_SATFINITE, __NV_E4M3));
}

// The chunk at i into dst: pools of the rows' own type take the bits as they
// are (one 8- or 16-byte store), int8 / fp8 pools x / scale packed into one
// 4-byte store.
template <typename TIn, typename TOut, bool kVec>
__device__ __forceinline__ void store_chunk(TOut* dst, int i, int d, const Chunk<TIn>& w,
                                            float scale) {
  if constexpr (std::is_same<TOut, TIn>::value) {
    if constexpr (kVec) {
      *reinterpret_cast<Chunk<TIn>*>(dst + i) = w;
    } else if constexpr (sizeof(TIn) == 4) {
      const uint32_t h[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (i + e < d) dst[i + e] = __uint_as_float(h[e]);
    } else {
      const uint32_t h[4] = {w.x & 0xFFFFu, w.x >> 16, w.y & 0xFFFFu, w.y >> 16};
      auto* raw = reinterpret_cast<uint16_t*>(dst);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (i + e < d) raw[i + e] = static_cast<uint16_t>(h[e]);
    }
  } else {
    float x[4];
    chunk_floats<TIn>(w, x);
    uint32_t b[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) b[e] = quant_byte(TOut{}, x[e] / scale);
    if constexpr (kVec) {
      *reinterpret_cast<uint32_t*>(dst + i) = b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24);
    } else {
      auto* bytes = reinterpret_cast<uint8_t*>(dst);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (i + e < d) bytes[i + e] = static_cast<uint8_t>(b[e]);
    }
  }
}

// kLanes lanes (16 or 32) own kRows consecutive rows (1, or 4 when the
// launch has rows enough to fill the card): the rows' first chunks are
// loaded before the block-table lookups they do not depend on, and all
// kRows rows' loads are in flight at once.
template <typename TIn, typename TOut, int kLanes, bool kVec, int kRows>
__global__ void __launch_bounds__(kMaxThreads) paged_append_kernel(
    const TIn* __restrict__ k_new,  // (b, sq, h_k, d)
    const TIn* __restrict__ v_new,
    TOut* __restrict__ k_pool,  // (pages, h_k, page, d): one layer's slice
    TOut* __restrict__ v_pool,
    float* __restrict__ k_scales,  // (pages, h_k, page), null for unquantized pools
    float* __restrict__ v_scales,
    const int32_t* __restrict__ block_tables,  // (b, max_pages)
    const int32_t* __restrict__ positions,     // (b,)
    int n_rows, int sq, int h_k, int d, int page, int max_pages, float inv_qmax) {
  constexpr bool kQuant = !std::is_same<TOut, TIn>::value;
  constexpr int kStride = 4 * kLanes;
  const int lane = threadIdx.x % kLanes;
  // rows [0, n_rows) are K's (token, kv head) rows, [n_rows, 2 n_rows) V's:
  // kv_row = (b * sq + t) * h_k + kvh
  const int first = (blockIdx.x * (blockDim.x / kLanes) + threadIdx.x / kLanes) * kRows;
  if (first >= 2 * n_rows) return;
  const unsigned group = kLanes == 32 ? 0xFFFFFFFFu
                                      : 0xFFFFu << (threadIdx.x & 31 & ~(kLanes - 1));
  const int i0 = 4 * lane;
  Chunk<TIn> w[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = first + r;
    w[r] = Chunk<TIn>{};
    if (row < 2 * n_rows && i0 < d) {
      const bool is_v = row >= n_rows;
      w[r] = load_chunk<TIn, kVec>((is_v ? v_new : k_new) +
                                  static_cast<size_t>(is_v ? row - n_rows : row) * d,
                              i0, d);
    }
  }
  // lane r finds row r's pool row (page entry -1: past the block table)
  int pe = -1, slot = 0;
  if (lane < kRows && first + lane < 2 * n_rows) {
    const int row = first + lane;
    const int tok = (row >= n_rows ? row - n_rows : row) / h_k;
    const int ib = tok / sq;
    const int pos = positions[ib] + tok % sq;
    const int lp = pos / page;
    if (pos >= 0 && lp < max_pages) {
      pe = block_tables[ib * max_pages + lp];
      slot = pos % page;
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row_pe = __shfl_sync(group, pe, r, kLanes);
    const int row_slot = __shfl_sync(group, slot, r, kLanes);
    if (row_pe < 0) continue;  // nothing to write
    const int row = first + r;
    const bool is_v = row >= n_rows;
    const int kv_row = is_v ? row - n_rows : row;
    const size_t dst_row = (static_cast<size_t>(row_pe) * h_k + kv_row % h_k) * page + row_slot;
    const TIn* src = (is_v ? v_new : k_new) + static_cast<size_t>(kv_row) * d;
    TOut* dst = (is_v ? v_pool : k_pool) + dst_row * d;
    float scale = 1.f;
    if constexpr (kQuant) {
      float amax = chunk_amax<TIn>(w[r]);
      for (int i = i0 + kStride; i < d; i += kStride)
        amax = fmaxf(amax, chunk_amax<TIn>(load_chunk<TIn, kVec>(src, i, d)));
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(group, amax, o, kLanes));
      scale = amax > 0.f ? amax * inv_qmax : 1.f;
      if (lane == 0) (is_v ? v_scales : k_scales)[dst_row] = scale;
    }
    if (i0 < d) store_chunk<TIn, TOut, kVec>(dst, i0, d, w[r], scale);
    for (int i = i0 + kStride; i < d; i += kStride)
      store_chunk<TIn, TOut, kVec>(dst, i, d, load_chunk<TIn, kVec>(src, i, d), scale);
  }
}

template <typename TIn, typename TOut, int kLanes>
cudaError_t launch_lanes(bool vec, const void* k_new, const void* v_new, void* k_pool,
                         void* v_pool, float* k_scales, float* v_scales, const int32_t* bt,
                         const int32_t* pos, int n_rows, int sq, int h_k, int d, int page,
                         int max_pages, float inv_qmax, cudaStream_t stream) {
  // 4 rows a group once that still gives every SM a full block; else one,
  // in blocks small enough (down to one warp) to give every SM a block
  const bool wide = 2 * n_rows >= 4 * (kMaxThreads / kLanes) * kSms;
  const int rows = wide ? 4 : 1;
  int threads = kMaxThreads;
  while (threads > 32 && 2 * n_rows * kLanes < threads * kSms) threads /= 2;
  const int groups = threads / kLanes;
  const int blocks = (2 * n_rows + groups * rows - 1) / (groups * rows);
  auto* kernel = wide ? (vec ? &paged_append_kernel<TIn, TOut, kLanes, true, 4>
                             : &paged_append_kernel<TIn, TOut, kLanes, false, 4>)
                      : (vec ? &paged_append_kernel<TIn, TOut, kLanes, true, 1>
                             : &paged_append_kernel<TIn, TOut, kLanes, false, 1>);
  kernel<<<blocks, threads, 0, stream>>>(
      static_cast<const TIn*>(k_new), static_cast<const TIn*>(v_new),
      static_cast<TOut*>(k_pool), static_cast<TOut*>(v_pool), k_scales, v_scales, bt, pos,
      n_rows, sq, h_k, d, page, max_pages, inv_qmax);
  return cudaGetLastError();
}

template <typename TIn, typename TOut>
cudaError_t launch(const void* k_new, const void* v_new, void* k_pool, void* v_pool,
                   float* k_scales, float* v_scales, const int32_t* bt, const int32_t* pos,
                   int b, int sq, int h_k, int d, int page, int max_pages, float qmax,
                   cudaStream_t stream) {
  // chunk loads of the rows (8 bytes, 16 for f32) and 4-byte (quantized) or
  // chunk stores: every row starts on such a boundary when d % 4 == 0 and
  // the bases do
  const uintptr_t load_align = 4 * sizeof(TIn);
  const uintptr_t store_align = qmax > 0.f ? 4 : load_align;
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(k_new) % load_align == 0 &&
                   reinterpret_cast<uintptr_t>(v_new) % load_align == 0 &&
                   reinterpret_cast<uintptr_t>(k_pool) % store_align == 0 &&
                   reinterpret_cast<uintptr_t>(v_pool) % store_align == 0;
  const int n_rows = b * sq * h_k;
  const float inv = qmax > 0.f ? 1.f / qmax : 0.f;
  if (d <= 64)
    return launch_lanes<TIn, TOut, 16>(vec, k_new, v_new, k_pool, v_pool, k_scales, v_scales, bt,
                                  pos, n_rows, sq, h_k, d, page, max_pages, inv, stream);
  return launch_lanes<TIn, TOut, 32>(vec, k_new, v_new, k_pool, v_pool, k_scales, v_scales, bt, pos,
                                n_rows, sq, h_k, d, page, max_pages, inv, stream);
}

template <typename TIn>
cudaError_t launch_pool(int pool_dtype, const void* k_new, const void* v_new, void* k_pool,
                        void* v_pool, float* ks, float* vs, const int32_t* bt, const int32_t* pos,
                        int b, int sq, int h_k, int d, int page, int max_pages, cudaStream_t st) {
  switch (pool_dtype) {
    case XFA_I8:
      return launch<TIn, int8_t>(k_new, v_new, k_pool, v_pool, ks, vs, bt, pos, b, sq, h_k, d,
                                 page, max_pages, 127.f, st);
    case XFA_FP8_E4M3:
      return launch<TIn, fp8e4m3_t>(k_new, v_new, k_pool, v_pool, ks, vs, bt, pos, b, sq, h_k,
                                    d, page, max_pages, 448.f, st);
    default:  // the rows' own type
      return launch<TIn, TIn>(k_new, v_new, k_pool, v_pool, ks, vs, bt, pos, b, sq, h_k, d,
                              page, max_pages, 0.f, st);
  }
}

}  // namespace

// k_new, v_new (b, sq, h_k, d) of row_dtype (bf16, f16 or f32); pools
// (pages, h_k, page, d) of pool_dtype: row_dtype itself, int8 or fp8-e4m3;
// scales (pages, h_k, page) f32 for int8 / fp8 pools, else null;
// block_tables (b, max_pages), positions (b,).
extern "C" int xfa_paged_append(const void* k_new, const void* v_new, int row_dtype,
                                void* k_pool, void* v_pool, int pool_dtype, void* k_scales,
                                void* v_scales, const void* block_tables, const void* positions,
                                int b, int sq, int h_k, int d, int page, int max_pages,
                                void* stream) {
  const bool quant = pool_dtype == XFA_I8 || pool_dtype == XFA_FP8_E4M3;
  if (quant && (k_scales == nullptr || v_scales == nullptr)) return cudaErrorInvalidValue;
  if (!quant && pool_dtype != row_dtype) return cudaErrorInvalidValue;
  if (b * sq * h_k == 0 || d == 0) return cudaSuccess;
  auto* ks = static_cast<float*>(k_scales);
  auto* vs = static_cast<float*>(v_scales);
  auto* bt = static_cast<const int32_t*>(block_tables);
  auto* pos = static_cast<const int32_t*>(positions);
  auto st = static_cast<cudaStream_t>(stream);
  switch (row_dtype) {
    case XFA_BF16:
      return launch_pool<__nv_bfloat16>(pool_dtype, k_new, v_new, k_pool, v_pool, ks, vs, bt,
                                        pos, b, sq, h_k, d, page, max_pages, st);
    case XFA_F16:
      return launch_pool<__half>(pool_dtype, k_new, v_new, k_pool, v_pool, ks, vs, bt, pos, b,
                                 sq, h_k, d, page, max_pages, st);
    case XFA_F32:
      return launch_pool<float>(pool_dtype, k_new, v_new, k_pool, v_pool, ks, vs, bt, pos, b,
                                sq, h_k, d, page, max_pages, st);
    default:
      return cudaErrorInvalidValue;
  }
}
