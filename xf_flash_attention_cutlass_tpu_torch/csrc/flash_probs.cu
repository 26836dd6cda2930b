// Normalized attention probabilities with the dropout mask sign-encoded (K8):
// the (b, h, sq, sk) f32 plane P = exp(S - LSE), masked entries and rows with
// LSE = -inf 0, entries the dropout dropped negated.
//
// Replaces the TPU kernel xf_flash_attention_cutlass_tpu/ops/flash_fwd.py
// `_probs_kernel` (:379, launched at :585), the debug pass behind
// `return_attn_probs`. S is K7's score: q pre-multiplied by the softmax scale
// and rounded to its dtype (the wrapper), the tanh softcap, then ALiBi's
// -slope * |qpos - kpos|, with K7's masks (causal / window from the bottom
// right or explicit positions, segment ids). The dropout mask is
// flash_common.cuh's Philox keyed by (seed, batch, q head, row, key), so the
// signs are the mask K7 and K9-K11 applied, whatever their tiling.
//
// Bound on an H100: bytes. The plane is 4 * b * h * sq * sk bytes of output
// (537 MB at (1, 32, 2048, 2048), 0.160 ms at 3.35 TB/s) against 2 * d
// operations per entry (0.017 ms causal at 989 TFLOP/s). Design: one block of
// 4 warps per (64-key tile, 64-row tile, batch * q head); each warp computes
// its 16 x 64 scores with mma.sync from shared-memory Q and K tiles, the f32
// epilogue goes through shared memory so that the stores are whole rows, 16
// bytes a thread. A tile pair that no visible entry can reach (causal /
// window geometry, kv tile past the keys, or the tile tables of explicit
// positions and segment ids) stores zeros without the product.
#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kBQ = 64;  // query rows per block (16 per warp)
constexpr int kBK = 64;  // keys per block
constexpr int kLDP = kBK + 4;  // f32 row stride of the staged output tile

template <int D>
constexpr int probs_smem_bytes() {
  return 2 * (kBQ + kBK) * (D + kPad) > kBQ * kLDP * 4 ? 2 * (kBQ + kBK) * (D + kPad)
                                                        : kBQ * kLDP * 4;
}

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

// Rows of the staged (kBQ, kBK) tile to out (b, h, sq, sk) f32, 16 bytes a
// thread when sk allows it.
__device__ __forceinline__ void store_tile(float* out, const float* tile, int q0, int k0,
                                           int sq, int sk) {
  const bool vec = (sk % 4) == 0;
  for (int i = threadIdx.x; i < kBQ * (kBK / 4); i += kThreads) {
    const int r = i / (kBK / 4), c = (i % (kBK / 4)) * 4;
    const int qi = q0 + r, kj = k0 + c;
    if (qi >= sq || kj >= sk) continue;
    float* dst = out + static_cast<size_t>(qi) * sk + kj;
    const float* src = tile + r * kLDP + c;
    if (vec) {
      *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
    } else {
      for (int e = 0; e < 4 && kj + e < sk; ++e) dst[e] = src[e];
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_probs_kernel(
    const T* __restrict__ q,  // (b, h, sq, D), pre-scaled
    const T* __restrict__ k,  // (b, h_k, sk, D)
    const float* __restrict__ lse,  // (b, h, sq)
    float* __restrict__ out,        // (b, h, sq, sk)
    const int32_t* __restrict__ qseg,  // (b, sq) or null
    const int32_t* __restrict__ kseg,  // (b, sk) or null
    int h, int h_k, int sq, int sk, int wl, int wr, float softcap, XfaExtras ex) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = D + kPad;
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + kBQ * LD;
  float* tile = reinterpret_cast<float*>(smem);  // reused after the product

  const int k0 = blockIdx.x * kBK, q0 = blockIdx.y * kBQ;
  const int ib = blockIdx.z / h, ih = blockIdx.z % h;
  const int ihk = ih / (h / h_k);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t bh = static_cast<size_t>(ib) * h + ih;
  const size_t bhk = static_cast<size_t>(ib) * h_k + ihk;
  float* outb = out + bh * sq * sk;
  const Mask mask = make_mask(ib, sq, sk, wl, wr, nullptr, qseg, kseg, ex);

  if (!tile_live(mask, ex, ib, q0, k0)) {
    for (int i = threadIdx.x; i < kBQ * kLDP; i += kThreads) tile[i] = 0.f;
    __syncthreads();
    store_tile(outb, tile, q0, k0, sq, sk);
    return;
  }

  copy_rows<T, D, kBQ>(qs, LD, q + bh * sq * D, q0, sq);
  copy_rows<T, D, kBK>(ks, LD, k + bhk * sk * D, k0, sk);
  __syncthreads();

  float s[kBK / 8][4];
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    load_a(af, qs + warp * 16 * LD + kk * 16, LD, lane);
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      uint32_t bf[2];
      load_b(bf, ks + j * 8 * LD + kk * 16, LD, lane);
      Mma<T>::run(s[j], af, bf);
    }
  }

  const int rl = warp * 16 + (lane >> 2);  // this thread's rows in the tile: rl, rl + 8
  const int col = (lane & 3) * 2;
  float lse_r[2], slope[2];
  bool live_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + rl + 8 * r;
    const float x = qi < sq ? lse[bh * sq + qi] : -INFINITY;
    live_r[r] = x > -3e38f;
    lse_r[r] = live_r[r] ? x : 0.f;
    slope[r] = alibi_slope(ex, ib, ih, h, sq, qi);
  }
  __syncthreads();  // Q and K are consumed: the tile buffer may be written
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + rl + 8 * r, kj = k0 + j * 8 + col;
      float p[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = s[j][2 * r + e];
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        x -= slope[r] * mask.dist(qi, kj + e);
        p[e] = (live_r[r] && mask.keep(qi, kj + e)) ? expf(x - lse_r[r]) : 0.f;
      }
      if (ex.drop_thresh != 0 && qi < sq) {
        bool keep0, keep1;
        dropout_keep2(ex, ib, ih, qi, kj, keep0, keep1);
        // only visible entries carry the sign: masked ones stay +0
        if (!keep0 && mask.keep(qi, kj)) p[0] = -p[0];
        if (!keep1 && mask.keep(qi, kj + 1)) p[1] = -p[1];
      }
      *reinterpret_cast<float2*>(tile + (rl + 8 * r) * kLDP + j * 8 + col) =
          make_float2(p[0], p[1]);
    }
  }
  __syncthreads();
  store_tile(outb, tile, q0, k0, sq, sk);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* lse, void* out, const int32_t* qseg,
                   const int32_t* kseg, int b, int h, int h_k, int sq, int sk, int wl, int wr,
                   float softcap, const XfaExtras& ex, cudaStream_t stream) {
  constexpr int smem = probs_smem_bytes<D>();
  auto kernel = flash_probs_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sk + kBK - 1) / kBK, (sq + kBQ - 1) / kBQ, b * h);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const float*>(lse),
      static_cast<float*>(out), qseg, kseg, h, h_k, sq, sk, wl, wr, softcap, ex);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int d, const void* q, const void* k, const void* lse, void* out,
                     const int32_t* qseg, const int32_t* kseg, int b, int h, int h_k, int sq,
                     int sk, int wl, int wr, float softcap, const XfaExtras& ex,
                     cudaStream_t stream) {
  if (d == 128)
    return launch<T, 128>(q, k, lse, out, qseg, kseg, b, h, h_k, sq, sk, wl, wr, softcap, ex,
                          stream);
  if (d == 64)
    return launch<T, 64>(q, k, lse, out, qseg, kseg, b, h, h_k, sq, sk, wl, wr, softcap, ex,
                         stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (b, h, sq, d) pre-scaled by the softmax scale, k (b, h_k, sk, d): contiguous
// bf16 (XFA_BF16) or fp16 (XFA_F16), d 64 or 128; lse (b, h, sq) f32 from the
// forward with the same options. Writes out (b, h, sq, sk) f32. q_seg (b, sq)
// and kv_seg (b, sk) int32 may be null; wl / wr the window (< 0 unbounded);
// extras as for xfa_flash_fwd, in host memory.
extern "C" int xfa_flash_probs(const void* q, const void* k, const void* lse, void* out,
                               const void* q_seg, const void* kv_seg, int dtype, int b, int h,
                               int h_k, int sq, int sk, int d, int wl, int wr, float softcap,
                               const flash::XfaExtras* extras, void* stream) {
  if (h_k <= 0 || h % h_k != 0 || extras == nullptr) return cudaErrorInvalidValue;
  if ((q_seg == nullptr) != (kv_seg == nullptr)) return cudaErrorInvalidValue;
  if ((extras->qpos == nullptr) != (extras->kpos == nullptr)) return cudaErrorInvalidValue;
  if ((extras->qtiles == nullptr) != (extras->ktiles == nullptr)) return cudaErrorInvalidValue;
  if (b == 0 || h == 0 || sq == 0 || sk == 0) return cudaSuccess;
  if (b * h > 65535 || (sq + kBQ - 1) / kBQ > 65535) return cudaErrorInvalidValue;
  auto* qs = static_cast<const int32_t*>(q_seg);
  auto* ks = static_cast<const int32_t*>(kv_seg);
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case XFA_BF16:
      return launch_d<__nv_bfloat16>(d, q, k, lse, out, qs, ks, b, h, h_k, sq, sk, wl, wr,
                                     softcap, *extras, st);
    case XFA_F16:
      return launch_d<__half>(d, q, k, lse, out, qs, ks, b, h, h_k, sq, sk, wl, wr, softcap,
                              *extras, st);
    default:
      return cudaErrorInvalidValue;
  }
}
