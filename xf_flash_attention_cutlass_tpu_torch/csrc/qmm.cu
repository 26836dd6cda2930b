// Weight-only quantized matmul y = x @ (W[l] * s[l]) (K3 + K4).
//
// Replaces the TPU kernels xf_flash_attention_cutlass_tpu/quant/linear.py
// `_qmm_stacked_kernel` (:70, layer l of an (L, K, N) int8/fp8 stack, or a
// bf16 stack with has_scale=False) and `_qmm_kernel` (:48, one (K, N) weight,
// the quantized lm_head). The wrapper selects layer l by pointer offset into
// the stack, so no per-layer copy is made; the plain (K, N) weight is the
// L = 1 case of the same entry points. Like the TPU kernels, every kernel
// here converts the weights to bf16 in fast memory and runs a bf16 product
// with f32 sums (exact: every int8 and every e4m3 value is a bf16 value), so
// device memory only ever sees one byte per weight; the per-output-channel
// scale is applied after the f32 sum and the result rounded to bf16 once.
//
// Three kernels, chosen by quant/linear.py::qmm_route:
//
// 1. qmm_wgmma_kernel, for m > 16 with TMA-legal operands (16-byte aligned
//    bases, row strides multiples of 16 bytes: every Llama-8B shape). Bound
//    on an H100 at Llama-8B widths: operations. A 256-row prefill chunk does
//    2 * 256 operations per one-byte weight, 111.7 GFLOP a layer: 0.113 ms at
//    989 TFLOP/s against 0.065 ms of weight bytes; m = 2048 is 0.90 ms of
//    operations. So the tensor cores must run near their rate, which only
//    wgmma reaches, and the weight conversion must hide behind the products
//    without adding traffic to shared memory, which wgmma already fills.
//    - It computes y^T = W^T x^T, as CUTLASS's mixed-input Hopper GEMMs do:
//      the weights are wgmma's A operand, converted to bf16 in registers,
//      and x is the B operand, K-major in shared memory; the tokens are
//      wgmma's N (128, or 256 above 128 rows). A block owns 128 weight
//      columns (64 per consumer warpgroup) x BT tokens.
//    - A producer warpgroup issues TMA loads into a ring of 4 stages with
//      full and empty mbarriers: per 64-deep k-tile the x tile (BT x 64
//      bf16) and the raw weight tile (64 x 128 bytes), both 128-byte
//      swizzled. TMA zero-fills rows and columns past M, N and K. The
//      producer gives most of its registers to the consumers (setmaxnreg).
//    - Each consumer warp reads its 16 weight columns of a k-tile with
//      `ldmatrix .trans`, treating pairs of bytes as 16-bit elements, and
//      converts them into the A fragments with a few bit operations and one
//      bf16x2 subtraction (int8) or product (e4m3) per pair; a bf16 stack
//      (no scale) needs no conversion. The A fragments are double-buffered:
//      one k-tile converts while the other's products run, and a warpgroup
//      waits only for the previous k-tile's products. The warpgroups never
//      wait for each other, and the weights never pass through shared memory
//      as bf16.
//    - The epilogue scales the f32 sums per column and stores bf16 pairs
//      (adjacent weight columns of one token) straight from the accumulator
//      layout; tokens past M and columns past N are masked.
//    - Blocks walk the token tiles fastest, so the blocks that share a
//      weight tile run together and read it from L2. Few output tiles (the
//      k and v projections at m = 256 make 8) are split over K to fill the
//      132 SMs; qmm_reduce_kernel sums the partials in a second launch.
//    Measured on an H100 (PERF.md): bf16 weights through shared memory (an
//    earlier design of this kernel, converting into a swizzled tile that
//    both warpgroups shared) ran int8 1.5x slower than the bf16 stack.
// 2. qmm_decode_kernel, for m <= 16 (decode) with TMA-legal operands. Bound
//    by bytes: at m = 8 a weight byte feeds 16 operations, about 54 TFLOP/s
//    at 3.35 TB/s, so the tensor cores idle and the kernel's only job is to
//    keep every SM's share of the weight bytes in flight (about 0.7 us of
//    DRAM latency times 25 GB/s an SM: at least 18 KB an SM, and more for
//    margin). 218 MB of int8 weights a Llama-8B layer is 65 us.
//    - The same y^T = W^T x^T, on mma.sync m16n8k16: the weight columns are
//      M, the tokens N (8 for m <= 8, 16 for m <= 16: NT n-tiles of 8), so
//      no row of the product is a row of zeros beyond the last n-tile.
//      Eight consumer warps own 16 weight columns each of a 128-column
//      block and convert their A fragments with the wgmma kernel's
//      `load_a`, unchanged; x's B fragments come from the staged x tile by
//      `ldmatrix` (x is K-major: a token's row of k is B's column).
//    - A producer warp (one lane) keeps a deep ring of TMA loads in flight:
//      per stage the raw 64 x 128 weight tile (bytes, or bf16 in two
//      64-column sub-tiles) and the tile of x beside it (8 or 16 tokens x 64
//      bf16), both 128-byte swizzled, zero-filled past M, N and K. The ring
//      takes as many stages as half of an SM's shared memory holds (6-12),
//      so two blocks are resident on an SM: 96-192 KB of weights in flight.
//    - Splits over K (quant/linear.py::qmm_decode_splits) are summed inside
//      the kernel: each split writes its f32 partial, fences, and bumps the
//      output tile's arrival counter; the block that arrives last adds the
//      partials in split order (the result does not depend on the order of
//      arrival), scales, stores bf16 and resets the counter to 0. The
//      counters are zeroed once, when the wrapper allocates them, so a call
//      needs no memset, no second launch and no read back to the host.
// 3. qmm_kernel, the WMMA (mma.sync) kernel, for operands TMA cannot take:
//    BM = 16 rows for m <= 16 and BM = 64 above, element-wise loads at the
//    ragged edge. Tiles of x (BM x 64) and W (64 x 128) are staged in
//    shared memory through registers, the next tile's loads in flight while
//    the current one is multiplied; few output tiles are split over K.
//
// Split partials (f32) of kernels 1 and 3 are summed by qmm_reduce_kernel in
// split order, so the result is deterministic, before the scale.
#include <mma.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

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

// ---- the wgmma kernel (m > 16, TMA-legal operands): y^T = W^T x^T ------------

namespace wg {

using namespace hopper;

constexpr int BN = 128;  // weight columns per block: 64 per consumer warpgroup
constexpr int BK = 64;   // k per stage: one 128-byte swizzled row of x
constexpr int kStages = 4;
constexpr int kSubBytes = BK * 128;  // one 64-column sub-tile of bf16 weights
constexpr int kConsumers = 256;
// and a producer warpgroup: ptxas budgets a wgmma kernel's registers by
// warpgroup, so a lone producer warp costs as much (with 288 threads the
// 256-token tile got 168 registers, spilled, and ptxas serialized its
// wgmma); the producer hands most of its registers to the consumers
// (setmaxnreg).
constexpr int kThreads = kConsumers + 128;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert(128 * kProducerRegs + kConsumers * kConsumerRegs <= 65536, "register file");

// Shared memory of one stage, from a 1024-byte aligned base: the x tile (BT
// tokens x BK, bf16, K-major: BT rows of 128 bytes, 128-byte swizzled), then
// the weight tile (BK rows of k x BN columns, 128-byte swizzled): int8 / fp8
// bytes in one tile of 128-byte rows, bf16 in two 64-column sub-tiles
// kSubBytes apart (warpgroup g reads sub-tile g).
template <typename TW, int BT>
struct Layout {
  static constexpr bool kQuant = sizeof(TW) == 1;
  static constexpr int kXBytes = BT * BK * 2;
  static constexpr int kWBytes = BN * BK * static_cast<int>(sizeof(TW));
  static constexpr int kStageBytes = kXBytes + kWBytes;  // a multiple of 1024
  static constexpr int kBarOffset = kStages * kStageBytes;
  static constexpr int kBytes = kBarOffset + 8 * 2 * kStages + 1024;  // + alignment slack
  static_assert(kBytes <= 232448, "the ring must fit in shared memory");
};

// The weight bytes become bf16 pairs by bf16x2_from_bytes02 (common.cuh).

// The A fragments of one stage for warp w of warpgroup g: the warp's 16
// weight columns x BK, as BK / 16 sets of four registers in the mma.sync
// m16n8k16 A layout (row r = lane / 4, k = 2 (lane % 4), per hopper.cuh).
// int8 / fp8: ldmatrix .trans treats each 128-byte row of k as 64 16-bit
// elements; a lane gets the bytes of columns 2r, 2r + 1 at k and k + 1,
// and bytes 0, 2 and 1, 3 of that word are the A pairs of column 2r and
// 2r + 1. So A row r holds column 2r, A row r + 8 column 2r + 1 (kPairs).
// bf16: ldmatrix .trans gives the A fragments as they are; A row r holds
// column r and row r + 8 column r + 8.
template <typename TW>
constexpr bool kPairs = sizeof(TW) == 1;

template <typename TW>
__device__ __forceinline__ void load_a(const unsigned char* wt, int g, int w, int lane,
                                       uint32_t (&a)[BK / 16][4]) {
  if constexpr (kPairs<TW>) {
    const int c = 4 * g + w;  // the warp's 16-byte chunk of each row
#pragma unroll
    for (int k2 = 0; k2 < BK / 32; ++k2) {
      const int k = 32 * k2 + lane;  // lane l names row l of the 32 rows
      uint32_t r[4];
      ldmatrix_x4_trans(r, wt + k * 128 + ((c ^ (k & 7)) << 4));
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // the k16 slices 2 k2 and 2 k2 + 1
        a[2 * k2 + h][0] = bf16x2_from_bytes02(TW{}, r[2 * h]);
        a[2 * k2 + h][1] = bf16x2_from_bytes02(TW{}, r[2 * h] >> 8);
        a[2 * k2 + h][2] = bf16x2_from_bytes02(TW{}, r[2 * h + 1]);
        a[2 * k2 + h][3] = bf16x2_from_bytes02(TW{}, r[2 * h + 1] >> 8);
      }
    }
  } else {
    const int j = lane >> 3;  // matrix j: columns 8 (j % 2) .., k 8 (j / 2) ..
    const int c = 2 * w + (j & 1);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const int k = 16 * kk + 8 * (j >> 1) + (lane & 7);
      ldmatrix_x4_trans(a[kk], wt + g * kSubBytes + k * 128 + ((c ^ (k & 7)) << 4));
    }
  }
}

template <typename TW, int BT>
__global__ void __launch_bounds__(kThreads, 1)
    qmm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_w,
                     const float* __restrict__ scale,  // (N,) or null
                     __nv_bfloat16* __restrict__ y,    // (M, N), written when splits == 1
                     float* __restrict__ partial,      // (splits, M, N), when splits > 1
                     int M, int N, int K, int kt_per_split) {
  using L = Layout<TW, BT>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* empty = full + kStages;
  auto x_tile = [&](int st) { return smem + st * L::kStageBytes; };
  auto w_tile = [&](int st) { return smem + st * L::kStageBytes + L::kXBytes; };

  const int m0 = blockIdx.x * BT;  // tokens fastest: blocks sharing a weight tile run together
  const int n0 = blockIdx.y * BN;
  const int n_kt = (K + BK - 1) / BK;
  const int kt0 = blockIdx.z * kt_per_split;
  const int kt1 = min(n_kt, kt0 + kt_per_split);

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 2);  // one arrival per consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup; one lane issues
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      for (int kt = kt0; kt < kt1; ++kt) {
        const int it = kt - kt0, st = it % kStages;
        mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], L::kStageBytes);
        tma_load_2d(x_tile(st), &tm_x, &full[st], kt * BK, m0);
        if constexpr (L::kQuant) {
          tma_load_2d(w_tile(st), &tm_w, &full[st], n0, kt * BK);
        } else {
          tma_load_2d(w_tile(st), &tm_w, &full[st], n0, kt * BK);
          tma_load_2d(w_tile(st) + kSubBytes, &tm_w, &full[st], n0 + 64, kt * BK);
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroups: g owns weight columns n0 + 64 g .. + 63 ----
  setmaxnreg_inc<kConsumerRegs>();
  const int tid = threadIdx.x;
  const int g = tid >> 7, w = (tid >> 5) & 3, lane = tid & 31;
  float acc[BT / 2];
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) acc[i] = 0.f;
  uint32_t a[2][BK / 16][4];  // the A fragments of two stages: one converts while
                              // the products of the other run

  // one k-tile; its A fragments go to a[P], with P a compile-time parity
  auto step = [&](auto parity, int kt) {
    constexpr int P = decltype(parity)::value;
    const int it = kt - kt0, st = it % kStages;
    mbar_wait(&full[st], (it / kStages) & 1);
    load_a<TW>(w_tile(st), g, w, lane, a[P]);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      Wgmma<__nv_bfloat16, BT>::rs(acc, a[P][kk], desc_sw128(x_tile(st) + kk * 32, 16, 1024),
                                   1);
    wgmma_commit();
    wgmma_wait<1>();  // the previous k-tile's products are done: its stage and
                      // its A registers are free
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) fence_regs(a[1 - P][kk]);
    if (it > 0 && (tid & 127) == 0) mbar_arrive(&empty[(it - 1) % kStages]);
  };
  int kt = kt0;
  for (; kt + 1 < kt1; kt += 2) {
    step(std::integral_constant<int, 0>{}, kt);
    step(std::integral_constant<int, 1>{}, kt + 1);
  }
  if (kt < kt1) step(std::integral_constant<int, 0>{}, kt);
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    fence_regs(a[0][kk]);
    fence_regs(a[1][kk]);
  }

  // epilogue from the accumulator layout (hopper.cuh): warp w holds A rows
  // lane / 4 and + 8 (weight columns n_lo, n_hi, per load_a) and, in
  // 8-token group j, tokens 8 j + 2 (lane % 4) and + 1. N is a multiple of
  // 8 here, so the pair (n_lo, n_lo + 1) is whole or past N.
  const int r = lane >> 2;
  const int n_lo = n0 + 64 * g + 16 * w + (kPairs<TW> ? 2 * r : r);
  const int n_hi = n_lo + (kPairs<TW> ? 1 : 8);
  float s_lo = 1.f, s_hi = 1.f;
  if (partial == nullptr && scale != nullptr) {
    if (n_lo < N) s_lo = scale[n_lo];
    if (n_hi < N) s_hi = scale[n_hi];
  }
  const int tok = m0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < BT / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int gm = tok + 8 * j + e;
      if (gm >= M) continue;
      const float v_lo = acc[4 * j + e], v_hi = acc[4 * j + 2 + e];
      if (partial != nullptr) {
        float* row = partial + (static_cast<size_t>(blockIdx.z) * M + gm) * N;
        if constexpr (kPairs<TW>) {
          if (n_lo < N) *reinterpret_cast<float2*>(row + n_lo) = make_float2(v_lo, v_hi);
        } else {
          if (n_lo < N) row[n_lo] = v_lo;
          if (n_hi < N) row[n_hi] = v_hi;
        }
      } else {
        __nv_bfloat16* row = y + static_cast<size_t>(gm) * N;
        if constexpr (kPairs<TW>) {
          if (n_lo < N)
            *reinterpret_cast<__nv_bfloat162*>(row + n_lo) =
                __floats2bfloat162_rn(v_lo * s_lo, v_hi * s_hi);
        } else {
          if (n_lo < N) row[n_lo] = to_bf16(v_lo * s_lo);
          if (n_hi < N) row[n_hi] = to_bf16(v_hi * s_hi);
        }
      }
    }
  }
}

template <typename TW, int BT>
cudaError_t launch(const void* x, const void* w, const float* scale, void* y, float* partial,
                   int M, int N, int K, int splits, int kt_per_split, cudaStream_t stream) {
  using L = Layout<TW, BT>;
  CUtensorMap tm_x, tm_w;
  const uint64_t x_dims[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(M)};
  const uint64_t x_strides[1] = {static_cast<uint64_t>(K) * 2};
  const uint32_t x_box[2] = {BK, BT};
  cudaError_t err = make_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, x_dims, x_strides,
                             x_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  const uint64_t w_dims[2] = {static_cast<uint64_t>(N), static_cast<uint64_t>(K)};
  const uint64_t w_strides[1] = {static_cast<uint64_t>(N) * sizeof(TW)};
  const uint32_t w_box[2] = {128 / sizeof(TW), BK};  // 128-byte rows
  const CUtensorMapDataType w_type =
      L::kQuant ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  err = make_map(&tm_w, w_type, 2, w, w_dims, w_strides, w_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(qmm_wgmma_kernel<TW, BT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((M + BT - 1) / BT, (N + BN - 1) / BN, splits);
  qmm_wgmma_kernel<TW, BT><<<grid, kThreads, L::kBytes, stream>>>(
      tm_x, tm_w, scale, static_cast<__nv_bfloat16*>(y), splits > 1 ? partial : nullptr, M, N,
      K, kt_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t mn = static_cast<size_t>(M) * N;
  const int blocks = static_cast<int>(std::min<size_t>((mn + 255) / 256, 4096));
  qmm_reduce_kernel<<<blocks, 256, 0, stream>>>(partial, scale, static_cast<__nv_bfloat16*>(y),
                                                splits, M, N);
  return cudaGetLastError();
}

template <typename TW>
cudaError_t launch_bt(int bt, const void* x, const void* w, const float* scale, void* y,
                      float* partial, int M, int N, int K, int splits, int kt_per_split,
                      cudaStream_t stream) {
  if (bt == 128)
    return launch<TW, 128>(x, w, scale, y, partial, M, N, K, splits, kt_per_split, stream);
  if (bt == 256)
    return launch<TW, 256>(x, w, scale, y, partial, M, N, K, splits, kt_per_split, stream);
  return cudaErrorInvalidValue;
}

}  // namespace wg

// ---- the decode kernel (m <= 16, TMA-legal operands): y^T = W^T x^T ----------

namespace dec {

using namespace hopper;
using wg::BK;
using wg::BN;
using wg::kPairs;
using wg::kSubBytes;
using wg::load_a;

constexpr int kWarps = 8;  // consumer warps: warp (g, w) = (warp / 4, warp % 4)
                           // owns the 16 weight columns load_a gives it
constexpr int kThreads = 32 * kWarps + 32;  // the consumers, then the producer warp
constexpr int kBlocksPerSm = 2;  // quant/linear.py's QMM_DECODE_BLOCKS_PER_SM

// Shared memory of one block, from a 1024-byte aligned base: the ring of
// stages, each the x tile (8 NT tokens x BK, bf16, K-major: one 128-byte
// swizzled row a token) then the weight tile (as the wgmma kernel's: BK rows
// of k x BN columns, bytes in one tile of 128-byte rows, bf16 in two 64-column
// sub-tiles kSubBytes apart), then the barriers and the last-arrival flag.
// The ring takes as many stages as half of an SM's 228 KB holds, so that
// exactly two blocks are resident whatever the instantiation (the split plan
// counts them).
template <typename TW, int NT>
struct Layout {
  static constexpr bool kQuant = sizeof(TW) == 1;
  static constexpr int kXBytes = NT * 8 * BK * 2;
  static constexpr int kWBytes = BN * BK * static_cast<int>(sizeof(TW));
  static constexpr int kStageBytes = kXBytes + kWBytes;  // a multiple of 1024
  static constexpr int kSmSmem = 233472;  // an SM's shared memory, 1 KB a block reserved
  static constexpr int kStages = (kSmSmem / kBlocksPerSm - 2048) / (kStageBytes + 16);
  static constexpr int kBarOffset = kStages * kStageBytes;
  static constexpr int kFlagOffset = kBarOffset + 16 * kStages;
  static constexpr int kBytes = kFlagOffset + 16 + 1024;  // + alignment slack
  static_assert(kBlocksPerSm * (kBytes + 1024) <= kSmSmem &&
                    (kBlocksPerSm + 1) * (kBytes + 1024) > kSmSmem,
                "exactly two blocks an SM");
};

// One block owns BN = 128 weight columns n0.. of one split of the k-tiles
// (blockIdx.y of gridDim.y splits, kt_per_split each) and all M <= 8 NT
// tokens. Warp (g, w) multiplies its 16 columns by the 8 NT tokens of every
// k-tile of the split on mma.sync m16n8k16: A is the weights (load_a), B is
// x, D (16 columns x 8 tokens) a thread's 4 NT f32 sums.
template <typename TW, int NT>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    qmm_decode_kernel(const __grid_constant__ CUtensorMap tm_x,
                      const __grid_constant__ CUtensorMap tm_w,
                      const float* __restrict__ scale,  // (N,) or null
                      __nv_bfloat16* __restrict__ y,    // (M, N)
                      float* __restrict__ partial,      // (splits, M, N), when splits > 1
                      int* __restrict__ counters,       // one per column tile, all 0 at entry
                      int M, int N, int K, int kt_per_split) {
  using L = Layout<TW, NT>;
  constexpr int kS = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* empty = full + kS;
  int* last_flag = reinterpret_cast<int*>(smem + L::kFlagOffset);
  auto x_tile = [&](int st) { return smem + st * L::kStageBytes; };
  auto w_tile = [&](int st) { return x_tile(st) + L::kXBytes; };

  const int n0 = blockIdx.x * BN;
  const int split = blockIdx.y, splits = gridDim.y;
  const int n_kt = (K + BK - 1) / BK;
  const int kt0 = split * kt_per_split;
  const int kt1 = min(n_kt, kt0 + kt_per_split);  // the plan keeps kt0 < kt1

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == kWarps && lane == 0) {  // the first loads' descriptors, while the barriers init
    prefetch_tensormap(&tm_x);
    prefetch_tensormap(&tm_w);
  }
  if (threadIdx.x == 0) {
    for (int st = 0; st < kS; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kWarps) {  // ---- the producer warp: one lane starts every copy ----
    if (lane == 0) {
      for (int kt = kt0; kt < kt1; ++kt) {
        const int i = kt - kt0, st = i % kS;
        mbar_wait(&empty[st], ((i / kS) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], L::kStageBytes);
        tma_load_2d(x_tile(st), &tm_x, &full[st], kt * BK, 0);
        tma_load_2d(w_tile(st), &tm_w, &full[st], n0, kt * BK);
        if constexpr (!L::kQuant)
          tma_load_2d(w_tile(st) + kSubBytes, &tm_w, &full[st], n0 + 64, kt * BK);
      }
    }
    return;
  }

  // ---- the consumer warps ----
  const int g = warp >> 2, w = warp & 3;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;

  // x's B fragments by ldmatrix (no transpose: a token's row of k is B's
  // column): the lane names row `xr` (a token) and 16-byte chunk `xc` + 2 kk
  // (NT = 2) or + 4 kk2 (NT = 1) of the swizzled x tile. NT = 1: matrices j
  // = 0..3 are the k chunks 4 kk2 + j of tokens 0-7, so k16 slice 2 kk2 + h
  // takes r[2h], r[2h + 1]; NT = 2: matrices (tokens 0-7 | 8-15) x (chunk
  // 2 kk | 2 kk + 1), n-tile n takes r[2n], r[2n + 1].
  const int xr = NT == 1 ? (lane & 7) : (lane & 7) + 8 * (lane >> 4);
  const int xc = NT == 1 ? (lane >> 3) : ((lane >> 3) & 1);

  for (int kt = kt0; kt < kt1; ++kt) {
    const int i = kt - kt0, st = i % kS;
    mbar_wait(&full[st], (i / kS) & 1);
    uint32_t a[BK / 16][4];
    load_a<TW>(w_tile(st), g, w, lane, a);
    const unsigned char* xt = x_tile(st) + xr * 128;
    if constexpr (NT == 1) {
#pragma unroll
      for (int kk2 = 0; kk2 < BK / 32; ++kk2) {
        uint32_t r[4];
        ldmatrix_x4(r, xt + (((4 * kk2 + xc) ^ (xr & 7)) << 4));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t b[2] = {r[2 * h], r[2 * h + 1]};
          mma_bf16_16816(acc[0], a[2 * kk2 + h], b);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t r[4];
        ldmatrix_x4(r, xt + (((2 * kk + xc) ^ (xr & 7)) << 4));
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const uint32_t b[2] = {r[2 * n], r[2 * n + 1]};
          mma_bf16_16816(acc[n], a[kk], b);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // the warp is done with the stage
  }

  // ---- epilogue, from the mma.sync D layout: a thread holds A rows lane / 4
  // and + 8 (weight columns n_lo, n_hi, per load_a) and, in n-tile n, tokens
  // 8 n + 2 (lane % 4) and + 1. N is a multiple of 8 here, so the pair
  // (n_lo, n_lo + 1) is whole or past N. ----
  const int r = lane >> 2;
  const int n_lo = n0 + 64 * g + 16 * w + (kPairs<TW> ? 2 * r : r);
  const int n_hi = n_lo + (kPairs<TW> ? 1 : 8);
  const int tok0 = 2 * (lane & 3);
  auto store_y = [&](float (&v)[NT][4]) {
    float s_lo = 1.f, s_hi = 1.f;
    if (scale != nullptr) {
      if (n_lo < N) s_lo = scale[n_lo];
      if (n_hi < N) s_hi = scale[n_hi];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gm = 8 * n + tok0 + e;
        if (gm >= M) continue;
        __nv_bfloat16* row = y + static_cast<size_t>(gm) * N;
        if constexpr (kPairs<TW>) {
          if (n_lo < N)
            *reinterpret_cast<__nv_bfloat162*>(row + n_lo) =
                __floats2bfloat162_rn(v[n][e] * s_lo, v[n][2 + e] * s_hi);
        } else {
          if (n_lo < N) row[n_lo] = to_bf16(v[n][e] * s_lo);
          if (n_hi < N) row[n_hi] = to_bf16(v[n][2 + e] * s_hi);
        }
      }
  };
  if (splits == 1) {
    store_y(acc);
    return;
  }

  // this split's f32 partial, then the output tile's arrival counter
  const size_t mn = static_cast<size_t>(M) * N;
  auto part = [&](int s, int gm) { return partial + s * mn + static_cast<size_t>(gm) * N; };
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int gm = 8 * n + tok0 + e;
      if (gm >= M) continue;
      float* row = part(split, gm);
      if constexpr (kPairs<TW>) {
        if (n_lo < N) *reinterpret_cast<float2*>(row + n_lo) = make_float2(acc[n][e], acc[n][2 + e]);
      } else {
        if (n_lo < N) row[n_lo] = acc[n][e];
        if (n_hi < N) row[n_hi] = acc[n][2 + e];
      }
    }
  __threadfence();  // the partial is visible device-wide before the arrival
  named_barrier_sync(1, 32 * kWarps);
  if (threadIdx.x == 0)
    *last_flag = atomicAdd(&counters[blockIdx.x], 1) == splits - 1;
  named_barrier_sync(1, 32 * kWarps);
  if (!*last_flag) return;

  // the last block to arrive: the partials summed in split order (this
  // block's own from its registers: the same f32 values), then y
  __threadfence();
  float sum[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) sum[n][j] = 0.f;
#pragma unroll 4  // the loads of four splits in flight; the adds stay in split order
  for (int s = 0; s < splits; ++s) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gm = 8 * n + tok0 + e;
        float v_lo = acc[n][e], v_hi = acc[n][2 + e];
        if (s != split && gm < M) {
          const float* row = part(s, gm);
          if constexpr (kPairs<TW>) {
            if (n_lo < N) {
              const float2 v = __ldcg(reinterpret_cast<const float2*>(row + n_lo));
              v_lo = v.x;
              v_hi = v.y;
            }
          } else {
            if (n_lo < N) v_lo = __ldcg(row + n_lo);
            if (n_hi < N) v_hi = __ldcg(row + n_hi);
          }
        }
        sum[n][e] += v_lo;
        sum[n][2 + e] += v_hi;
      }
  }
  store_y(sum);
  if (threadIdx.x == 0) counters[blockIdx.x] = 0;  // ready for the next call
}

template <typename TW, int NT>
cudaError_t prepare() {
  // raise the dynamic shared-memory limit once per instantiation (one device)
  static cudaError_t err = cudaFuncSetAttribute(qmm_decode_kernel<TW, NT>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                Layout<TW, NT>::kBytes);
  return err;
}

template <typename TW, int NT>
cudaError_t launch(const void* x, const void* w, const float* scale, void* y, float* partial,
                   int* counters, int M, int N, int K, int splits, int kt_per_split,
                   cudaStream_t stream) {
  using L = Layout<TW, NT>;
  CUtensorMap tm_x, tm_w;
  const uint64_t x_dims[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(M)};
  const uint64_t x_strides[1] = {static_cast<uint64_t>(K) * 2};
  const uint32_t x_box[2] = {BK, 8 * NT};
  cudaError_t err = make_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, x_dims, x_strides,
                             x_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  const uint64_t w_dims[2] = {static_cast<uint64_t>(N), static_cast<uint64_t>(K)};
  const uint64_t w_strides[1] = {static_cast<uint64_t>(N) * sizeof(TW)};
  const uint32_t w_box[2] = {128 / sizeof(TW), BK};  // 128-byte rows
  err = make_map(&tm_w, L::kQuant ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                 2, w, w_dims, w_strides, w_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  err = prepare<TW, NT>();
  if (err != cudaSuccess) return err;
  dim3 grid((N + BN - 1) / BN, splits);
  qmm_decode_kernel<TW, NT><<<grid, kThreads, L::kBytes, stream>>>(
      tm_x, tm_w, scale, static_cast<__nv_bfloat16*>(y), partial, counters, M, N, K,
      kt_per_split);
  return cudaGetLastError();
}

template <typename TW>
cudaError_t launch_rows(int M, const void* x, const void* w, const float* scale, void* y,
                        float* partial, int* counters, int N, int K, int splits,
                        int kt_per_split, cudaStream_t stream) {
  if (M <= 8)
    return launch<TW, 1>(x, w, scale, y, partial, counters, M, N, K, splits, kt_per_split,
                         stream);
  if (M <= 16)
    return launch<TW, 2>(x, w, scale, y, partial, counters, M, N, K, splits, kt_per_split,
                         stream);
  return cudaErrorInvalidValue;
}

template <typename TW, int NT>
int blocks_per_sm() {
  int n = -1;
  if (prepare<TW, NT>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, qmm_decode_kernel<TW, NT>, kThreads,
                                                    Layout<TW, NT>::kBytes) != cudaSuccess)
    return -1;
  return n;
}

template <typename TW>
int blocks_per_sm_rows(int rows) {
  return rows == 8 ? blocks_per_sm<TW, 1>() : rows == 16 ? blocks_per_sm<TW, 2>() : -1;
}

}  // namespace dec

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

// The wgmma kernel: as xfa_qmm, for M > 16 with x contiguous (row stride K
// elements) and w of row stride N elements, both 16-byte aligned, K * 2 and
// N * sizeof(w) multiples of 16 (quant/linear.py::qmm_route); tiles of bt
// tokens (bt: 128 or 256) x 128 weight columns, splits over K as the caller
// plans them (qmm_splits).
extern "C" int xfa_qmm_wgmma(const void* x, const void* w, int w_dtype, const void* scale,
                             void* y, void* partial, int M, int N, int K, int splits,
                             int kt_per_split, int bt, void* stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  if (splits < 1 || (splits > 1 && partial == nullptr) || N % 8 != 0 || K % 8 != 0)
    return cudaErrorInvalidValue;
  auto* s = static_cast<const float*>(scale);
  auto* p = static_cast<float*>(partial);
  auto st = static_cast<cudaStream_t>(stream);
  switch (w_dtype) {
    case XFA_I8:
      return wg::launch_bt<int8_t>(bt, x, w, s, y, p, M, N, K, splits, kt_per_split, st);
    case XFA_FP8_E4M3:
      return wg::launch_bt<fp8e4m3_t>(bt, x, w, s, y, p, M, N, K, splits, kt_per_split, st);
    case XFA_BF16:
      return wg::launch_bt<__nv_bfloat16>(bt, x, w, s, y, p, M, N, K, splits, kt_per_split,
                                          st);
    default:
      return cudaErrorInvalidValue;
  }
}

// The decode kernel: as xfa_qmm_wgmma, for 1 <= M <= 16 (tiles of 8 tokens
// for M <= 8, else 16) with the same operand rules. splits > 1 needs the f32
// scratch `partial` (splits, M, N) and `counters`: one int32 per 128-column
// tile, all 0 at entry, and all 0 again when the kernel ends (the last split
// of each tile resets its own). No second launch.
extern "C" int xfa_qmm_decode(const void* x, const void* w, int w_dtype, const void* scale,
                              void* y, void* partial, void* counters, int M, int N, int K,
                              int splits, int kt_per_split, void* stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  if (splits < 1 || (splits > 1 && (partial == nullptr || counters == nullptr)) ||
      N % 8 != 0 || K % 8 != 0 || (splits - 1) * kt_per_split >= (K + 63) / 64 ||
      splits * kt_per_split < (K + 63) / 64)
    return cudaErrorInvalidValue;
  auto* s = static_cast<const float*>(scale);
  auto* p = static_cast<float*>(partial);
  auto* c = static_cast<int*>(counters);
  auto st = static_cast<cudaStream_t>(stream);
  switch (w_dtype) {
    case XFA_I8:
      return dec::launch_rows<int8_t>(M, x, w, s, y, p, c, N, K, splits, kt_per_split, st);
    case XFA_FP8_E4M3:
      return dec::launch_rows<fp8e4m3_t>(M, x, w, s, y, p, c, N, K, splits, kt_per_split, st);
    case XFA_BF16:
      return dec::launch_rows<__nv_bfloat16>(M, x, w, s, y, p, c, N, K, splits, kt_per_split,
                                             st);
    default:
      return cudaErrorInvalidValue;
  }
}

// Resident blocks an SM of the decode kernel for a weight dtype and its rows
// (8 or 16), by the CUDA occupancy calculator; -1 on error.
extern "C" int xfa_qmm_decode_blocks_per_sm(int w_dtype, int rows) {
  switch (w_dtype) {
    case XFA_I8:
      return dec::blocks_per_sm_rows<int8_t>(rows);
    case XFA_FP8_E4M3:
      return dec::blocks_per_sm_rows<fp8e4m3_t>(rows);
    case XFA_BF16:
      return dec::blocks_per_sm_rows<__nv_bfloat16>(rows);
    default:
      return -1;
  }
}
