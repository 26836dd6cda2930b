// In-place paged KV append with per-token quantization (K2 + K5).
//
// Replaces the TPU kernels xf_flash_attention_cutlass_tpu/ops/paged_append.py
// `_decode_append_kernel` (:68, one token per row at any position) and
// `_prefill_append_kernel` (:166, a chunk of tokens at window-aligned
// positions). On a GPU the TPU's tile-aligned window read-modify-write and its
// alignment rules do not apply: a thread block owns one (token, kv head, K|V)
// row, so one kernel serves decode (sq = 1), verify-style (sq > 1 at any
// position) and chunked prefill alike.
//
// Bound on an H100 (3.35 TB/s): bytes. At the main path's shapes the append
// reads the new bf16 rows once (b*sq*h_k*d*2 bytes each for K and V) and
// writes one 1-byte value row plus one f32 scale per row: 8*8*128 tokens x
// heads at decode is ~0.1 us of traffic, so the launch itself dominates.
// Design: one block per row, one thread per element, a block-wide amax, then
// each thread quantizes and stores its element. Nothing is staged; the
// write lands directly in pool[bt[b, pos / page], h, pos % page, :].
//
// Quantization is bit-exact with the pools the JAX package writes (see the
// port's quant/kv.py):
//   scale = amax * (1 / qmax) in float32 (1 when amax == 0) — the form XLA
//   compiles the reference's amax / qmax to — and y = x / scale (IEEE),
//   int8: rintf (half to even), clip to +-127; fp8-e4m3: clip to +-448, then
//   round-to-nearest-even with saturation.
// Built without --use_fast_math so that the division and rintf stay IEEE.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename TOut>
__device__ __forceinline__ void store_quant(TOut* dst, float y);

template <>
__device__ __forceinline__ void store_quant<int8_t>(int8_t* dst, float y) {
  float r = fminf(fmaxf(rintf(y), -127.f), 127.f);
  *dst = static_cast<int8_t>(r);
}

template <>
__device__ __forceinline__ void store_quant<fp8e4m3_t>(fp8e4m3_t* dst, float y) {
  float c = fminf(fmaxf(y, -448.f), 448.f);
  dst->x = static_cast<uint8_t>(__nv_cvt_float_to_fp8(c, __NV_SATFINITE, __NV_E4M3));
}

template <typename TOut, bool kQuant>
__global__ void __launch_bounds__(kThreads) paged_append_kernel(
    const __nv_bfloat16* __restrict__ k_new,  // (b, sq, h_k, d)
    const __nv_bfloat16* __restrict__ v_new,
    TOut* __restrict__ k_pool,  // (pages, h_k, page, d): one layer's slice
    TOut* __restrict__ v_pool,
    float* __restrict__ k_scales,  // (pages, h_k, page) or null
    float* __restrict__ v_scales,
    const int32_t* __restrict__ block_tables,  // (b, max_pages)
    const int32_t* __restrict__ positions,     // (b,)
    int sq, int h_k, int d, int page, int max_pages, float inv_qmax) {
  __shared__ float scratch[kThreads / 32];
  const int row = blockIdx.x;  // b * sq + t
  const int kvh = blockIdx.y;
  const bool is_v = blockIdx.z == 1;
  const int ib = row / sq;
  const int pos = positions[ib] + row % sq;
  const int lp = pos / page;
  if (pos < 0 || lp >= max_pages) return;  // past the block table: nothing to write
  const int pe = block_tables[ib * max_pages + lp];
  const size_t dst_row = (static_cast<size_t>(pe) * h_k + kvh) * page + pos % page;
  const __nv_bfloat16* src = (is_v ? v_new : k_new) + (static_cast<size_t>(row) * h_k + kvh) * d;
  TOut* dst = (is_v ? v_pool : k_pool) + dst_row * d;

  if constexpr (!kQuant) {
    for (int i = threadIdx.x; i < d; i += blockDim.x) dst[i] = src[i];
  } else {
    float amax = 0.f;
    for (int i = threadIdx.x; i < d; i += blockDim.x) amax = fmaxf(amax, fabsf(to_float(src[i])));
    amax = block_max(amax, scratch);
    const float scale = amax > 0.f ? amax * inv_qmax : 1.f;
    for (int i = threadIdx.x; i < d; i += blockDim.x) store_quant(dst + i, to_float(src[i]) / scale);
    if (threadIdx.x == 0) (is_v ? v_scales : k_scales)[dst_row] = scale;
  }
}

template <typename TOut, bool kQuant>
cudaError_t launch(const void* k_new, const void* v_new, void* k_pool, void* v_pool,
                   float* k_scales, float* v_scales, const int32_t* bt, const int32_t* pos,
                   int b, int sq, int h_k, int d, int page, int max_pages, float qmax,
                   cudaStream_t stream) {
  dim3 grid(b * sq, h_k, 2);
  paged_append_kernel<TOut, kQuant><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(k_new), static_cast<const __nv_bfloat16*>(v_new),
      static_cast<TOut*>(k_pool), static_cast<TOut*>(v_pool), k_scales, v_scales, bt, pos, sq,
      h_k, d, page, max_pages, qmax > 0.f ? 1.f / qmax : 0.f);
  return cudaGetLastError();
}

}  // namespace

// k_new, v_new (b, sq, h_k, d) bf16; pools (pages, h_k, page, d) of
// pool_dtype (bf16, int8 or fp8-e4m3); scales (pages, h_k, page) f32 for
// int8 / fp8 pools, else null; block_tables (b, max_pages), positions (b,).
extern "C" int xfa_paged_append(const void* k_new, const void* v_new, void* k_pool,
                                void* v_pool, int pool_dtype, void* k_scales, void* v_scales,
                                const void* block_tables, const void* positions, int b, int sq,
                                int h_k, int d, int page, int max_pages, void* stream) {
  const bool quant = pool_dtype == XFA_I8 || pool_dtype == XFA_FP8_E4M3;
  if (quant && (k_scales == nullptr || v_scales == nullptr)) return cudaErrorInvalidValue;
  if (b * sq == 0) return cudaSuccess;
  auto* ks = static_cast<float*>(k_scales);
  auto* vs = static_cast<float*>(v_scales);
  auto* bt = static_cast<const int32_t*>(block_tables);
  auto* pos = static_cast<const int32_t*>(positions);
  auto st = static_cast<cudaStream_t>(stream);
  switch (pool_dtype) {
    case XFA_BF16:
      return launch<__nv_bfloat16, false>(k_new, v_new, k_pool, v_pool, ks, vs, bt, pos, b, sq,
                                          h_k, d, page, max_pages, 0.f, st);
    case XFA_I8:
      return launch<int8_t, true>(k_new, v_new, k_pool, v_pool, ks, vs, bt, pos, b, sq, h_k, d,
                                  page, max_pages, 127.f, st);
    case XFA_FP8_E4M3:
      return launch<fp8e4m3_t, true>(k_new, v_new, k_pool, v_pool, ks, vs, bt, pos, b, sq, h_k,
                                     d, page, max_pages, 448.f, st);
    default:
      return cudaErrorInvalidValue;
  }
}
