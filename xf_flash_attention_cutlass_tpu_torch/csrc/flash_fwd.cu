// Dense flash-attention forward (K7): O and the log-sum-exp of every query row.
//
// Replaces the TPU kernel xf_flash_attention_cutlass_tpu/ops/flash_fwd.py
// `_flash_fwd_kernel` (:100). The TPU kernel runs its grid in order and keeps
// the online-softmax state (m, l, O) in VMEM scratch across the sequential KV
// grid axis; a sparse table of live (q, kv) block pairs skips fully masked
// blocks. Here one block of 4 warps owns one (batch, q head, 64-row q tile);
// a loop over 64-key tiles takes the place of the KV grid axis, and its bounds
// come from the causal / window geometry and kv_lens, so masked tiles are never
// loaded. Each warp owns 16 query rows: its Q fragments, its running max and
// sum (f32) and its O accumulator (f32) stay in registers for the whole loop.
// S = Q K^T and O += P V run on the tensor cores (mma.sync m16n8k16, bf16 or
// fp16 in, f32 sums); P goes from the S accumulators to the A operand of P V
// without touching shared memory.
//
// Numerics follow the TPU kernel: q arrives pre-multiplied by the softmax
// scale and rounded to its dtype (the wrapper), masked scores are the finite
// NEG_INF, the running max has the floor -1e30, the tanh softcap acts on the
// scaled scores, ALiBi subtracts slope * |qpos - kpos| after it, P is rounded
// to V's dtype for the product, O = acc * (1 / l), and rows that see no key
// give O = 0 and LSE = -inf. Dropout zeroes P after the row sum (the mask is
// flash_common.cuh's Philox, keyed by batch, q head, row and key) and O takes
// 1 / (1 - p) in the epilogue.
//
// The options (ALiBi, explicit positions, tile tables, dropout) live in the
// kExtra instantiation only, so the option-free kernel pays nothing for
// them. With explicit positions the index geometry no longer bounds the
// key loop: the block walks every key tile below kv_len and skips the tiles
// whose positions and segment ids (from the wrapper's tile tables) cannot meet
// its rows'.
//
// Bound on an H100: operations. A causal tile pair costs 4 * 64 * 64 * d
// tensor-core operations against 2 * 64 * d * 2 bytes of K and V, far above
// the card's ~295 operations per byte. This first version feeds the tensor
// cores from shared memory with plain loads and synchronous copies (no TMA,
// no wgmma, no pipelining); making it fast is later work.
#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kBQ = 64;  // query rows per block (16 per warp)
constexpr int kBK = 64;  // keys per tile

template <int D>
constexpr int fwd_smem_bytes() {
  return 2 * (kBQ * (D + kPad) + kBK * (D + kPad) + D * (kBK + kPad));
}

template <typename T, int D, bool kExtra>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q,  // (b, h, sq, D), pre-scaled
    const T* __restrict__ k,  // (b, h_k, sk, D)
    const T* __restrict__ v,
    T* __restrict__ o,         // (b, h, sq, D)
    float* __restrict__ lse,   // (b, h, sq)
    const int32_t* __restrict__ kv_lens,  // (b,) or null
    const int32_t* __restrict__ qseg,     // (b, sq) or null
    const int32_t* __restrict__ kseg,     // (b, sk) or null
    int h, int h_k, int sq, int sk, int wl, int wr, float softcap, XfaExtras ex) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = D + kPad;     // row stride of Q and K tiles
  constexpr int LDT = kBK + kPad;  // row stride of the transposed V tile
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + kBQ * LD;
  T* vt = ks + kBK * LD;  // V^T: (D, kBK)

  const int iq = blockIdx.x, ih = blockIdx.y, ib = blockIdx.z;
  const int ihk = ih / (h / h_k);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = iq * kBQ;
  const size_t bh = static_cast<size_t>(ib) * h + ih;
  const size_t bhk = static_cast<size_t>(ib) * h_k + ihk;
  const T* qb = q + bh * sq * D;
  const T* kb = k + bhk * sk * D;
  const T* vb = v + bhk * sk * D;
  Mask mask = make_mask(ib, sq, sk, wl, wr, kv_lens, qseg, kseg, ex);
  if constexpr (!kExtra) mask.qpos = mask.kpos = nullptr;

  copy_rows<T, D, kBQ>(qs, LD, qb, q0, sq);
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) load_a(qf[kk], qs + warp * 16 * LD + kk * 16, LD, lane);

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_row[2] = {kMFloor, kMFloor};
  float l_row[2] = {0.f, 0.f};  // this thread's part of the row sums
  const int row = q0 + warp * 16 + (lane >> 2);  // and row + 8
  const int col = (lane & 3) * 2;
  float slope[2] = {0.f, 0.f};
  if constexpr (kExtra) {
    slope[0] = alibi_slope(ex, ib, ih, h, sq, row);
    slope[1] = alibi_slope(ex, ib, ih, h, sq, row + 8);
  }

  int k_lo, k_hi;
  mask.key_range(q0, min(q0 + kBQ, sq), k_lo, k_hi);
  for (int k0 = (k_lo / kBK) * kBK; k0 < k_hi; k0 += kBK) {
    if constexpr (kExtra) {
      if (!tiles_meet(ex, mask, ib, q0, k0)) continue;  // uniform over the block
    }
    __syncthreads();  // the previous tile is consumed
    copy_rows<T, D, kBK>(ks, LD, kb, k0, sk);
    copy_rows_t<T, D, kBK>(vt, LDT, vb, k0, sk);
    __syncthreads();

    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        uint32_t bf[2];
        load_b(bf, ks + j * 8 * LD + kk * 16, LD, lane);
        Mma<T>::run(s[j], qf[kk], bf);
      }
    }

    // softcap, ALiBi, mask, then the online-softmax update of both rows
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = row + (e >> 1) * 8, kj = k0 + j * 8 + col + (e & 1);
        float x = s[j][e];
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        if constexpr (kExtra) x -= slope[e >> 1] * mask.dist(qi, kj);
        s[j][e] = mask.keep(qi, kj) ? x : kNegInf;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_row[r], mx);
      const float corr = expf(m_row[r] - m_new);
      m_row[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        s[j][2 * r] = expf(s[j][2 * r] - m_new);
        s[j][2 * r + 1] = expf(s[j][2 * r + 1] - m_new);
        sum += s[j][2 * r] + s[j][2 * r + 1];
      }
      l_row[r] = l_row[r] * corr + sum;
      if constexpr (kExtra) {  // dropout: P leaves the sum whole, the product without
        if (ex.drop_thresh != 0) {
#pragma unroll
          for (int j = 0; j < kBK / 8; ++j) {
            bool keep0, keep1;
            dropout_keep2(ex, ib, ih, row + 8 * r, k0 + j * 8 + col, keep0, keep1);
            if (!keep0) s[j][2 * r] = 0.f;
            if (!keep1) s[j][2 * r + 1] = 0.f;
          }
        }
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][2 * r] *= corr;
        acc[n][2 * r + 1] *= corr;
      }
    }

    // O += P V, P rounded to V's dtype
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pf[4];
      c_to_a<T>(pf, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t bf[2];
        load_b(bf, vt + n * 8 * LDT + kk * 16, LDT, lane);
        Mma<T>::run(acc[n], pf, bf);
      }
    }
  }

  // epilogue: the four threads of a row hold parts of its sum
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_row[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int qi = row + r * 8;
    if (qi >= sq) continue;
    const bool empty = l <= 0.f;
    const float inv = empty ? 1.f : 1.f / l;
    const float drop_scale = kExtra ? ex.drop_scale : 1.f;
    T* orow = o + (bh * sq + qi) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float x0 = empty ? 0.f : acc[n][2 * r] * inv * drop_scale;
      const float x1 = empty ? 0.f : acc[n][2 * r + 1] * inv * drop_scale;
      *reinterpret_cast<uint32_t*>(orow + n * 8 + col) = Mma<T>::pack(x0, x1);
    }
    if ((lane & 3) == 0) lse[bh * sq + qi] = empty ? -INFINITY : m_row[r] + logf(l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                   const int32_t* kv_lens, const int32_t* qseg, const int32_t* kseg, int b,
                   int h, int h_k, int sq, int sk, int wl, int wr, float softcap,
                   const XfaExtras& ex, cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<D>();
  auto* kernel = has_extras(ex) ? &flash_fwd_kernel<T, D, true> : &flash_fwd_kernel<T, D, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), kv_lens, qseg, kseg, h, h_k, sq, sk, wl,
      wr, softcap, ex);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int d, const void* q, const void* k, const void* v, void* o, void* lse,
                     const int32_t* kv_lens, const int32_t* qseg, const int32_t* kseg, int b,
                     int h, int h_k, int sq, int sk, int wl, int wr, float softcap,
                     const XfaExtras& ex, cudaStream_t stream) {
  if (d == 128)
    return launch<T, 128>(q, k, v, o, lse, kv_lens, qseg, kseg, b, h, h_k, sq, sk, wl, wr,
                          softcap, ex, stream);
  if (d == 64)
    return launch<T, 64>(q, k, v, o, lse, kv_lens, qseg, kseg, b, h, h_k, sq, sk, wl, wr,
                         softcap, ex, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (b, h, sq, d) pre-scaled by the softmax scale; k, v (b, h_k, sk, d); all
// contiguous bf16 (dtype XFA_BF16) or fp16 (XFA_F16), d 64 or 128. Writes
// o (b, h, sq, d) and lse (b, h, sq) f32. kv_lens (b,), q_seg (b, sq) and
// kv_seg (b, sk) int32 may be null. wl / wr: window, < 0 unbounded. extras:
// ALiBi, positions, tile tables and dropout (flash_common.cuh), host memory.
extern "C" int xfa_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                             const void* kv_lens, const void* q_seg, const void* kv_seg,
                             int dtype, int b, int h, int h_k, int sq, int sk, int d, int wl,
                             int wr, float softcap, const flash::XfaExtras* extras, void* stream) {
  if (h_k <= 0 || h % h_k != 0 || extras == nullptr) return cudaErrorInvalidValue;
  if ((q_seg == nullptr) != (kv_seg == nullptr)) return cudaErrorInvalidValue;
  if ((extras->qpos == nullptr) != (extras->kpos == nullptr)) return cudaErrorInvalidValue;
  if ((extras->qtiles == nullptr) != (extras->ktiles == nullptr)) return cudaErrorInvalidValue;
  if (b * h * sq == 0) return cudaSuccess;
  auto* lens = static_cast<const int32_t*>(kv_lens);
  auto* qs = static_cast<const int32_t*>(q_seg);
  auto* ks = static_cast<const int32_t*>(kv_seg);
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case XFA_BF16:
      return launch_d<__nv_bfloat16>(d, q, k, v, o, lse, lens, qs, ks, b, h, h_k, sq, sk, wl,
                                     wr, softcap, *extras, st);
    case XFA_F16:
      return launch_d<__half>(d, q, k, v, o, lse, lens, qs, ks, b, h, h_k, sq, sk, wl, wr,
                              softcap, *extras, st);
    default:
      return cudaErrorInvalidValue;
  }
}
