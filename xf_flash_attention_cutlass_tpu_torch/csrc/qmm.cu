// Weight-only quantized matmul y = x @ (W[l] * s[l]) (K3 + K4).
//
// Replaces the TPU kernels xf_flash_attention_cutlass_tpu/quant/linear.py
// `_qmm_stacked_kernel` (:70, layer l of an (L, K, N) int8/fp8 stack, or a
// bf16 stack with has_scale=False) and `_qmm_kernel` (:48, one (K, N) weight,
// the quantized lm_head). The wrapper selects layer l by pointer offset into
// the stack, so no per-layer copy is made; the plain (K, N) weight is the
// L = 1 case of the same entry point.
//
// Bound on an H100 at the main path's shapes (Llama-8B, int8 weights):
// decode (m = 8) reads every weight byte once and does 2 flops per byte
// per row, so it is bound by bytes: 218 MB of int8 weights per layer is
// 65 us at 3.35 TB/s. A 256-token prefill chunk does 2*256 flops per
// weight; at 989 TFLOP/s (bf16) that is 113 us per layer against 65 us of
// weight traffic, so the chunk is bound by operations.
// Design: tensor cores through WMMA (bf16 in, f32 accumulate). Tiles of x
// (BM x 64, bf16) and W (64 x 128) are staged in shared memory, the next
// tile's loads held in registers while the current one is multiplied; the int8 /
// fp8 weight tile is converted to bf16 as it is stored there (exact: every
// int8 and every e4m3 value is a bf16 value), so device memory only ever
// sees one byte per weight. The per-output-channel scale is applied in the
// epilogue, after the f32 sum, as the TPU kernel does. Small m uses
// BM = 16 so that decode does not stream the weights through 64-row tiles
// of zeros, and few output tiles are split over K (grid.z) to put enough
// blocks on the 132 SMs; split partials are summed by a second kernel,
// in a fixed order, before the scale.
#include <mma.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int kThreads = 128;
constexpr int BN = 128;
constexpr int BK = 64;
constexpr int LDX = BK + 8;   // padded smem row of the x tile (bf16)
constexpr int LDW = BN + 8;   // padded smem row of the W tile (bf16)
constexpr int LDC = BN + 4;   // padded smem row of the f32 output tile

template <int BM>
struct Layout;
template <>
struct Layout<16> {
  static constexpr int WARPS_M = 1, WARPS_N = 4;
};
template <>
struct Layout<64> {
  static constexpr int WARPS_M = 2, WARPS_N = 2;
};

template <int BM>
constexpr int smem_bytes() {
  constexpr int ab = BM * LDX * 2 + BK * LDW * 2;
  constexpr int c = BM * LDC * 4;
  return ab > c ? ab : c;
}

// 16 bytes of W converted to bf16 and stored at dst (16 / sizeof(TW) values)
template <typename TW>
__device__ __forceinline__ void convert_store16(__nv_bfloat16* dst, const uint4& raw) {
  constexpr int E = 16 / sizeof(TW);
  const TW* v = reinterpret_cast<const TW*>(&raw);
#pragma unroll
  for (int e = 0; e < E; ++e) dst[e] = to_bf16(to_float(v[e]));
}

// 16 bytes from base[idx...]: one vector load when allowed and whole, else
// element by element with zeros past `valid` elements (valid may be <= 0)
template <typename U>
__device__ __forceinline__ uint4 load16(const U* base, size_t idx, int valid, bool vec) {
  constexpr int E = 16 / sizeof(U);
  if (vec && valid >= E) return *reinterpret_cast<const uint4*>(base + idx);
  union {
    uint4 u;
    U e[E];
  } r;
  r.u = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int i = 0; i < E; ++i)
    if (i < valid) r.e[i] = base[idx + i];
  return r.u;
}

// One k-tile of x (BM x BK bf16) and W (BK x BN) as raw 16-byte chunks in
// registers, so that the next tile's loads are in flight while the current
// one is multiplied from shared memory.
template <int BM, typename TW>
struct KTileRegs {
  using Raw = std::conditional_t<sizeof(TW) == 1, uint8_t, uint16_t>;
  static constexpr int EW = 16 / sizeof(TW);  // weights per chunk
  static constexpr int XL = BM * (BK / 8) / kThreads;   // x chunks per thread
  static constexpr int WL = BK * (BN / EW) / kThreads;  // W chunks per thread
  static_assert(BM * (BK / 8) % kThreads == 0 && BK * (BN / EW) % kThreads == 0,
                "tile chunks must split evenly over the threads");
  uint4 xr[XL], wr[WL];

  __device__ __forceinline__ void load(const __nv_bfloat16* x, const TW* w, int M, int N, int K,
                                       int m0, int n0, int k0, bool vec_x, bool vec_w) {
#pragma unroll
    for (int it = 0; it < XL; ++it) {
      const int c = threadIdx.x + it * kThreads;
      const int gm = m0 + c / (BK / 8), gk = k0 + (c % (BK / 8)) * 8;
      xr[it] = load16(reinterpret_cast<const uint16_t*>(x), static_cast<size_t>(gm) * K + gk,
                      gm < M ? K - gk : 0, vec_x);
    }
#pragma unroll
    for (int it = 0; it < WL; ++it) {
      const int c = threadIdx.x + it * kThreads;
      const int gk = k0 + c / (BN / EW), gn = n0 + (c % (BN / EW)) * EW;
      wr[it] = load16(reinterpret_cast<const Raw*>(w), static_cast<size_t>(gk) * N + gn,
                      gk < K ? N - gn : 0, vec_w);
    }
  }

  // x as it is; W converted to bf16 on the way in
  __device__ __forceinline__ void store(__nv_bfloat16* xs, __nv_bfloat16* ws) const {
#pragma unroll
    for (int it = 0; it < XL; ++it) {
      const int c = threadIdx.x + it * kThreads;
      *reinterpret_cast<uint4*>(xs + (c / (BK / 8)) * LDX + (c % (BK / 8)) * 8) = xr[it];
    }
#pragma unroll
    for (int it = 0; it < WL; ++it) {
      const int c = threadIdx.x + it * kThreads;
      convert_store16<TW>(ws + (c / (BN / EW)) * LDW + (c % (BN / EW)) * EW, wr[it]);
    }
  }
};

template <int BM, typename TW>
__global__ void __launch_bounds__(kThreads) qmm_kernel(
    const __nv_bfloat16* __restrict__ x,  // (M, K)
    const TW* __restrict__ w,             // (K, N): layer l of the stack
    const float* __restrict__ scale,      // (N,) or null (has_scale=False)
    __nv_bfloat16* __restrict__ y,        // (M, N), written when splits == 1
    float* __restrict__ partial,          // (splits, M, N), written when splits > 1
    int M, int N, int K, int kt_per_split, bool vec_x, bool vec_w) {
  constexpr int WM = BM / Layout<BM>::WARPS_M;
  constexpr int WN = BN / Layout<BM>::WARPS_N;
  constexpr int FM = WM / 16, FN = WN / 16;

  extern __shared__ __align__(128) unsigned char smem[];
  auto* xs = reinterpret_cast<__nv_bfloat16*>(smem);         // [BM][LDX]
  auto* ws = xs + BM * LDX;                                  // [BK][LDW]
  auto* cs = reinterpret_cast<float*>(smem);                 // [BM][LDC], after the loop

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int warp = threadIdx.x >> 5;
  const int wm = warp / Layout<BM>::WARPS_N, wn = warp % Layout<BM>::WARPS_N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int n_kt = (K + BK - 1) / BK;
  const int kt0 = blockIdx.z * kt_per_split;
  const int kt1 = min(n_kt, kt0 + kt_per_split);
  KTileRegs<BM, TW> regs;
  if (kt0 < kt1) regs.load(x, w, M, N, K, m0, n0, kt0 * BK, vec_x, vec_w);
  for (int kt = kt0; kt < kt1; ++kt) {
    regs.store(xs, ws);
    __syncthreads();
    if (kt + 1 < kt1)  // in flight while this tile is multiplied
      regs.load(x, w, M, N, K, m0, n0, (kt + 1) * BK, vec_x, vec_w);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bfr[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], xs + (wm * WM + i * 16) * LDX + kk, LDX);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(bfr[j], ws + kk * LDW + wn * WN + j * 16, LDW);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a[i], bfr[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue through shared memory: scale per output channel, cast, store
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(cs + (wm * WM + i * 16) * LDC + wn * WN + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < BM * BN; e += kThreads) {
    const int r = e / BN, cn = e % BN;
    const int gm = m0 + r, gn = n0 + cn;
    if (gm >= M || gn >= N) continue;
    const float v = cs[r * LDC + cn];
    if (partial != nullptr) {
      partial[(static_cast<size_t>(blockIdx.z) * M + gm) * N + gn] = v;
    } else {
      y[static_cast<size_t>(gm) * N + gn] =
          to_bf16(scale != nullptr ? v * scale[gn] : v);
    }
  }
}

// y = (sum over splits of partial) * scale, summed in split order
__global__ void qmm_reduce_kernel(const float* __restrict__ partial,
                                  const float* __restrict__ scale,
                                  __nv_bfloat16* __restrict__ y, int splits, int M, int N) {
  const size_t mn = static_cast<size_t>(M) * N;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < mn;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < splits; ++s) v += partial[s * mn + i];
    if (scale != nullptr) v *= scale[i % N];
    y[i] = to_bf16(v);
  }
}

template <int BM, typename TW>
cudaError_t launch(const void* x, const void* w, const float* scale, void* y, float* partial,
                   int M, int N, int K, int splits, int kt_per_split, bool vec_x, bool vec_w,
                   cudaStream_t stream) {
  constexpr int smem = smem_bytes<BM>();
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  qmm_kernel<BM, TW><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const TW*>(w), scale,
      static_cast<__nv_bfloat16*>(y), splits > 1 ? partial : nullptr, M, N, K, kt_per_split,
      vec_x, vec_w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t mn = static_cast<size_t>(M) * N;
  const int blocks = static_cast<int>(std::min<size_t>((mn + 255) / 256, 4096));
  qmm_reduce_kernel<<<blocks, 256, 0, stream>>>(partial, scale,
                                                static_cast<__nv_bfloat16*>(y), splits, M, N);
  return cudaGetLastError();
}

template <int BM>
cudaError_t dispatch_w(int w_dtype, const void* x, const void* w, const float* scale, void* y,
                       float* partial, int M, int N, int K, int splits, int kt_per_split,
                       bool vec_x, bool vec_w, cudaStream_t stream) {
  switch (w_dtype) {
    case XFA_I8:
      return launch<BM, int8_t>(x, w, scale, y, partial, M, N, K, splits, kt_per_split, vec_x,
                                vec_w, stream);
    case XFA_FP8_E4M3:
      return launch<BM, fp8e4m3_t>(x, w, scale, y, partial, M, N, K, splits, kt_per_split,
                                   vec_x, vec_w, stream);
    case XFA_BF16:
      return launch<BM, __nv_bfloat16>(x, w, scale, y, partial, M, N, K, splits, kt_per_split,
                                       vec_x, vec_w, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (M, K) bf16; w: (K, N) of w_dtype; scale: (N,) f32 or null; y: (M, N)
// bf16; partial: (splits, M, N) f32 scratch, used when splits > 1. bm (16 or
// 64) is the rows of x per block, chosen by the caller (quant/linear.py).
extern "C" int xfa_qmm(const void* x, const void* w, int w_dtype, const void* scale, void* y,
                       void* partial, int M, int N, int K, int splits, int kt_per_split,
                       int vec_x, int vec_w, int bm, void* stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  if (splits < 1 || (splits > 1 && partial == nullptr)) return cudaErrorInvalidValue;
  auto* s = static_cast<const float*>(scale);
  auto* p = static_cast<float*>(partial);
  auto st = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 16:
      return dispatch_w<16>(w_dtype, x, w, s, y, p, M, N, K, splits, kt_per_split, vec_x != 0,
                            vec_w != 0, st);
    case 64:
      return dispatch_w<64>(w_dtype, x, w, s, y, p, M, N, K, splits, kt_per_split, vec_x != 0,
                            vec_w != 0, st);
    default:
      return cudaErrorInvalidValue;
  }
}
