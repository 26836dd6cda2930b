// Dense flash-attention backward: K9 (dQ pass), K10 (dK/dV pass) and K11 (one
// pass, dQ by atomics), sharing one recompute of P and dS.
//
// Replaces the TPU kernels of xf_flash_attention_cutlass_tpu/ops/flash_bwd.py:
// `_dq_kernel` (:228), `_dkv_kernel` (:284) and `_bwd_fused_kernel` (:156).
// Every kernel recomputes, for its (query, key) tiles,
//   S = Q K^T * scale (tanh softcap), P = exp(S - LSE) (masked entries 0),
//   dP = dO V^T, dS = P (dP - Delta) (softcap derivative) * scale,
// with Delta = rowsum(dO * O) computed by the wrapper in plain torch, as the
// JAX package leaves it to XLA. Then
//   K9:  one block per (batch, q head, 64-row q tile), a loop over the key
//        tiles its rows see; dQ += dS K sums in f32 registers (no atomics).
//   K10: one block per (batch, kv head, 64-key tile), loops over the GQA
//        group's q heads and the 32-row q tiles that see its keys;
//        dV += P^T dO and dK += dS^T Q sum in f32 registers, so the GQA head
//        sum happens in the kernel (the TPU kernel's :14-17) with no pass after.
//   K11: K10's block and loops, plus dQ: dS goes through shared memory and the
//        block's dS K is added to an f32 dQ buffer with atomicAdd. Atomics sum
//        in an order that changes from run to run, so dQ of K11 is not
//        bit-reproducible; it agrees with K9 to f32 rounding of the sum.
// In K9 each warp owns 16 query rows; in K10/K11 each warp owns 16 keys and
// works on S^T = K Q^T, so the P^T and dS^T accumulators are the A operands of
// the dV and dK products straight from registers.
//
// Bound on an H100: operations (2.5x the forward's: five tile products per
// live tile pair in K11, seven over K9 and K10). Like K7 this first version
// feeds mma.sync from shared memory with synchronous copies.
#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kBQ = 64;    // K9: query rows per block
constexpr int kBK = 64;    // keys per tile (K9 loop, K10/K11 block)
constexpr int kBQT = 32;   // K10/K11: query rows per loop tile

struct BwdArgs {
  const void *q, *k, *v, *dout, *lse, *delta;  // lse, delta: (b, h, sq) f32
  void *dq, *dk, *dv;  // dq (b, h, sq, d) in the input dtype, unused by K10/K11
  float* dq_acc;       // K11: (b, h, sq, d) f32, zeroed by the caller
  const int32_t *kv_lens, *qseg, *kseg;
  int b, h, h_k, sq, sk, wl, wr;
  float scale, softcap;
};

template <int D>
constexpr int dq_smem_bytes() {
  return 2 * (2 * kBQ * (D + kPad) + 2 * kBK * (D + kPad) + D * (kBK + kPad));
}

template <int D, bool kFused>
constexpr int dkv_smem_bytes() {
  return 2 * (2 * kBK * (D + kPad) + 2 * kBQT * (D + kPad) + 2 * D * (kBQT + kPad) +
              (kFused ? kBQT * (kBK + kPad) + D * (kBK + kPad) : 0)) +
         2 * kBQT * 4;
}

// ---- K9: dQ -------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = D + kPad, LDT = kBK + kPad;
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = qs + kBQ * LD;
  T* ks = dos + kBQ * LD;
  T* vs = ks + kBK * LD;
  T* kt = vs + kBK * LD;  // K^T: (D, kBK)

  const int iq = blockIdx.x, ih = blockIdx.y, ib = blockIdx.z;
  const int ihk = ih / (a.h / a.h_k);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = iq * kBQ;
  const size_t bh = static_cast<size_t>(ib) * a.h + ih;
  const size_t bhk = static_cast<size_t>(ib) * a.h_k + ihk;
  const T* qb = static_cast<const T*>(a.q) + bh * a.sq * D;
  const T* dob = static_cast<const T*>(a.dout) + bh * a.sq * D;
  const T* kb = static_cast<const T*>(a.k) + bhk * a.sk * D;
  const T* vb = static_cast<const T*>(a.v) + bhk * a.sk * D;
  const Mask mask = make_mask(ib, a.sq, a.sk, a.wl, a.wr, a.kv_lens, a.qseg, a.kseg);

  const int row = q0 + warp * 16 + (lane >> 2);  // and row + 8
  const int col = (lane & 3) * 2;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = min(row + 8 * r, a.sq - 1);
    lse_r[r] = safe_lse(static_cast<const float*>(a.lse)[bh * a.sq + qi]);
    delta_r[r] = static_cast<const float*>(a.delta)[bh * a.sq + qi];
  }

  copy_rows<T, D, kBQ>(qs, LD, qb, q0, a.sq);
  copy_rows<T, D, kBQ>(dos, LD, dob, q0, a.sq);

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int k_lo, k_hi;
  mask.key_range(q0, min(q0 + kBQ, a.sq), k_lo, k_hi);
  for (int k0 = (k_lo / kBK) * kBK; k0 < k_hi; k0 += kBK) {
    __syncthreads();
    copy_rows<T, D, kBK>(ks, LD, kb, k0, a.sk);
    copy_rows<T, D, kBK>(vs, LD, vb, k0, a.sk);
    copy_rows_t<T, D, kBK>(kt, LDT, kb, k0, a.sk);
    __syncthreads();

    float s[kBK / 8][4], dp[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qf[4], df[4];
      load_a(qf, qs + warp * 16 * LD + kk * 16, LD, lane);
      load_a(df, dos + warp * 16 * LD + kk * 16, LD, lane);
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        uint32_t bf[2];
        load_b(bf, ks + j * 8 * LD + kk * 16, LD, lane);
        Mma<T>::run(s[j], qf, bf);
        load_b(bf, vs + j * 8 * LD + kk * 16, LD, lane);
        Mma<T>::run(dp[j], df, bf);
      }
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool keep = mask.keep(row + 8 * r, k0 + j * 8 + col + (e & 1));
        float p;
        recompute_p_ds(s[j][e], dp[j][e], lse_r[r], delta_r[r], keep, a.scale, a.softcap, p,
                       s[j][e]);  // s now holds dS
      }
    }
    // dQ += dS K, dS rounded to K's dtype
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[4];
      c_to_a<T>(af, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t bf[2];
        load_b(bf, kt + n * 8 * LDT + kk * 16, LDT, lane);
        Mma<T>::run(acc[n], af, bf);
      }
    }
  }

  T* dqb = static_cast<T*>(a.dq) + bh * a.sq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row + 8 * r;
    if (qi >= a.sq) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(dqb + static_cast<size_t>(qi) * D + n * 8 + col) =
          Mma<T>::pack(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// ---- K10 / K11: dK, dV (and dQ by atomics) -------------------------------------

template <typename T, int D, bool kFused>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = D + kPad, LDQ = kBQT + kPad, LDK = kBK + kPad;
  T* ks = reinterpret_cast<T*>(smem);  // (kBK, D): A of S^T
  T* vs = ks + kBK * LD;               // (kBK, D): A of dP^T
  T* qs = vs + kBK * LD;               // (kBQT, D): B of S^T
  T* dos = qs + kBQT * LD;             // (kBQT, D): B of dP^T
  T* qt = dos + kBQT * LD;             // Q^T (D, kBQT): B of dK
  T* dot = qt + D * LDQ;               // dO^T (D, kBQT): B of dV
  T* dss = dot + D * LDQ;              // K11: dS (kBQT, kBK), A of dQ
  T* kt = dss + (kFused ? kBQT * LDK : 0);  // K11: K^T (D, kBK), B of dQ
  float* lse_s = reinterpret_cast<float*>(kt + (kFused ? D * LDK : 0));
  float* delta_s = lse_s + kBQT;

  const int ik = blockIdx.x, ihk = blockIdx.y, ib = blockIdx.z;
  const int group = a.h / a.h_k;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = ik * kBK;
  const size_t bhk = static_cast<size_t>(ib) * a.h_k + ihk;
  const T* kb = static_cast<const T*>(a.k) + bhk * a.sk * D;
  const T* vb = static_cast<const T*>(a.v) + bhk * a.sk * D;
  const Mask mask = make_mask(ib, a.sq, a.sk, a.wl, a.wr, a.kv_lens, a.qseg, a.kseg);

  const int krow = k0 + warp * 16 + (lane >> 2);  // this thread's keys: krow, krow + 8
  const int col = (lane & 3) * 2;                 // its query columns in an n-tile

  copy_rows<T, D, kBK>(ks, LD, kb, k0, a.sk);
  copy_rows<T, D, kBK>(vs, LD, vb, k0, a.sk);
  if constexpr (kFused) copy_rows_t<T, D, kBK>(kt, LDK, kb, k0, a.sk);

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  int q_lo, q_hi;
  mask.query_range(k0, k0 + kBK, q_lo, q_hi);
  for (int g = 0; g < group; ++g) {
    const int ih = ihk * group + g;
    const size_t bh = static_cast<size_t>(ib) * a.h + ih;
    const T* qb = static_cast<const T*>(a.q) + bh * a.sq * D;
    const T* dob = static_cast<const T*>(a.dout) + bh * a.sq * D;
    const float* lseb = static_cast<const float*>(a.lse) + bh * a.sq;
    const float* deltab = static_cast<const float*>(a.delta) + bh * a.sq;
    for (int q0 = (q_lo / kBQT) * kBQT; q0 < q_hi; q0 += kBQT) {
      __syncthreads();  // the previous q tile (and dS) are consumed
      copy_rows<T, D, kBQT>(qs, LD, qb, q0, a.sq);
      copy_rows<T, D, kBQT>(dos, LD, dob, q0, a.sq);
      copy_rows_t<T, D, kBQT>(qt, LDQ, qb, q0, a.sq);
      copy_rows_t<T, D, kBQT>(dot, LDQ, dob, q0, a.sq);
      for (int i = threadIdx.x; i < kBQT; i += kThreads) {
        const bool live = q0 + i < a.sq;
        lse_s[i] = live ? safe_lse(lseb[q0 + i]) : 3.0e38f;
        delta_s[i] = live ? deltab[q0 + i] : 0.f;
      }
      __syncthreads();

      float st[kBQT / 8][4], dpt[kBQT / 8][4];  // S^T, dP^T: (16 keys, kBQT queries)
#pragma unroll
      for (int j = 0; j < kBQT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t kf[4], vf[4];
        load_a(kf, ks + warp * 16 * LD + kk * 16, LD, lane);
        load_a(vf, vs + warp * 16 * LD + kk * 16, LD, lane);
#pragma unroll
        for (int j = 0; j < kBQT / 8; ++j) {
          uint32_t bf[2];
          load_b(bf, qs + j * 8 * LD + kk * 16, LD, lane);
          Mma<T>::run(st[j], kf, bf);
          load_b(bf, dos + j * 8 * LD + kk * 16, LD, lane);
          Mma<T>::run(dpt[j], vf, bf);
        }
      }
#pragma unroll
      for (int j = 0; j < kBQT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = j * 8 + col + (e & 1);  // query column within the tile
          const int kj = krow + (e >> 1) * 8;
          recompute_p_ds(st[j][e], dpt[j][e], lse_s[qc], delta_s[qc],
                         mask.keep(q0 + qc, kj), a.scale, a.softcap, st[j][e], dpt[j][e]);
        }
      }
      // dV += P^T dO (P rounded to dO's dtype), dK += dS^T Q (dS to Q's dtype)
#pragma unroll
      for (int kk = 0; kk < kBQT / 16; ++kk) {
        uint32_t pf[4], sf[4];
        c_to_a<T>(pf, st[2 * kk], st[2 * kk + 1]);
        c_to_a<T>(sf, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          uint32_t bf[2];
          load_b(bf, dot + n * 8 * LDQ + kk * 16, LDQ, lane);
          Mma<T>::run(dv[n], pf, bf);
          load_b(bf, qt + n * 8 * LDQ + kk * 16, LDQ, lane);
          Mma<T>::run(dk[n], sf, bf);
        }
      }

      if constexpr (kFused) {
        // dS^T from registers into shared memory as dS (queries, keys)
        const int kl = warp * 16 + (lane >> 2);
#pragma unroll
        for (int j = 0; j < kBQT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dss[(j * 8 + col + (e & 1)) * LDK + kl + (e >> 1) * 8] = Mma<T>::from_float(dpt[j][e]);
        __syncthreads();
        // dQ tile (kBQT, D) += dS K: warp w takes rows (w & 1) * 16 and half
        // of the D columns, and adds its 16 x D/2 products to the f32 buffer
        const int mt = warp & 1, n0 = (warp >> 1) * (D / 16);
        float qacc[D / 16][4];
#pragma unroll
        for (int n = 0; n < D / 16; ++n) qacc[n][0] = qacc[n][1] = qacc[n][2] = qacc[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          uint32_t af[4];
          load_a(af, dss + mt * 16 * LDK + kk * 16, LDK, lane);
#pragma unroll
          for (int n = 0; n < D / 16; ++n) {
            uint32_t bf[2];
            load_b(bf, kt + (n0 + n) * 8 * LDK + kk * 16, LDK, lane);
            Mma<T>::run(qacc[n], af, bf);
          }
        }
        float* dqb = a.dq_acc + bh * a.sq * D;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int qi = q0 + mt * 16 + (lane >> 2) + 8 * r;
          if (qi >= a.sq) continue;
#pragma unroll
          for (int n = 0; n < D / 16; ++n) {
            float* dst = dqb + static_cast<size_t>(qi) * D + (n0 + n) * 8 + col;
            atomicAdd(dst, qacc[n][2 * r]);
            atomicAdd(dst + 1, qacc[n][2 * r + 1]);
          }
        }
      }
    }
  }

  T* dkb = static_cast<T*>(a.dk) + bhk * a.sk * D;
  T* dvb = static_cast<T*>(a.dv) + bhk * a.sk * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = krow + 8 * r;
    if (kj >= a.sk) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const size_t off = static_cast<size_t>(kj) * D + n * 8 + col;
      *reinterpret_cast<uint32_t*>(dkb + off) = Mma<T>::pack(dk[n][2 * r], dk[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dvb + off) = Mma<T>::pack(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

template <typename Kernel>
cudaError_t run(Kernel kernel, dim3 grid, int smem, cudaStream_t stream, const BwdArgs& a) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const BwdArgs& a, cudaStream_t stream) {
  dim3 grid((a.sq + kBQ - 1) / kBQ, a.h, a.b);
  return run(flash_bwd_dq_kernel<T, D>, grid, dq_smem_bytes<D>(), stream, a);
}

template <typename T, int D>
cudaError_t launch_dkv(const BwdArgs& a, bool fused, cudaStream_t stream) {
  dim3 grid((a.sk + kBK - 1) / kBK, a.h_k, a.b);
  if (fused)
    return run(flash_bwd_dkv_kernel<T, D, true>, grid, dkv_smem_bytes<D, true>(), stream, a);
  return run(flash_bwd_dkv_kernel<T, D, false>, grid, dkv_smem_bytes<D, false>(), stream, a);
}

BwdArgs make_args(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, void* dq, void* dk, void* dv,
                  void* dq_acc, const void* kv_lens, const void* q_seg, const void* kv_seg,
                  int b, int h, int h_k, int sq, int sk, int wl, int wr, float scale,
                  float softcap) {
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.dq_acc = static_cast<float*>(dq_acc);
  a.kv_lens = static_cast<const int32_t*>(kv_lens);
  a.qseg = static_cast<const int32_t*>(q_seg);
  a.kseg = static_cast<const int32_t*>(kv_seg);
  a.b = b;
  a.h = h;
  a.h_k = h_k;
  a.sq = sq;
  a.sk = sk;
  a.wl = wl;
  a.wr = wr;
  a.scale = scale;
  a.softcap = softcap;
  return a;
}

bool valid(int dtype, int d, int h, int h_k, const void* q_seg, const void* kv_seg) {
  return (dtype == XFA_BF16 || dtype == XFA_F16) && (d == 64 || d == 128) && h_k > 0 &&
         h % h_k == 0 && (q_seg == nullptr) == (kv_seg == nullptr);
}

}  // namespace

// Arguments of both entry points: q, dout (b, h, sq, d); k, v (b, h_k, sk, d);
// all contiguous bf16 (XFA_BF16) or fp16 (XFA_F16), d 64 or 128, q NOT
// pre-scaled; lse, delta (b, h, sq) f32; kv_lens (b,), q_seg (b, sq), kv_seg
// (b, sk) int32 or null; wl / wr the window (< 0 unbounded).

// K9: writes dq (b, h, sq, d) in the input dtype.
extern "C" int xfa_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dq,
                                const void* kv_lens, const void* q_seg, const void* kv_seg,
                                int dtype, int b, int h, int h_k, int sq, int sk, int d, int wl,
                                int wr, float scale, float softcap, void* stream) {
  if (!valid(dtype, d, h, h_k, q_seg, kv_seg)) return cudaErrorInvalidValue;
  if (b * h * sq == 0) return cudaSuccess;
  const BwdArgs a = make_args(q, k, v, dout, lse, delta, dq, nullptr, nullptr, nullptr, kv_lens,
                              q_seg, kv_seg, b, h, h_k, sq, sk, wl, wr, scale, softcap);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == XFA_BF16)
    return d == 128 ? launch_dq<__nv_bfloat16, 128>(a, st) : launch_dq<__nv_bfloat16, 64>(a, st);
  return d == 128 ? launch_dq<__half, 128>(a, st) : launch_dq<__half, 64>(a, st);
}

// K10 (fused = 0): writes dk, dv (b, h_k, sk, d) in the input dtype.
// K11 (fused = 1): also adds dQ into dq_acc (b, h, sq, d) f32, which the
// caller zeroes before and casts after.
extern "C" int xfa_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dk, void* dv,
                                 void* dq_acc, const void* kv_lens, const void* q_seg,
                                 const void* kv_seg, int dtype, int b, int h, int h_k, int sq,
                                 int sk, int d, int wl, int wr, float scale, float softcap,
                                 int fused, void* stream) {
  if (!valid(dtype, d, h, h_k, q_seg, kv_seg)) return cudaErrorInvalidValue;
  if (fused && dq_acc == nullptr) return cudaErrorInvalidValue;
  if (b * h_k * sk == 0) return cudaSuccess;
  const BwdArgs a = make_args(q, k, v, dout, lse, delta, nullptr, dk, dv, dq_acc, kv_lens,
                              q_seg, kv_seg, b, h, h_k, sq, sk, wl, wr, scale, softcap);
  auto st = static_cast<cudaStream_t>(stream);
  const bool f = fused != 0;
  if (dtype == XFA_BF16)
    return d == 128 ? launch_dkv<__nv_bfloat16, 128>(a, f, st)
                    : launch_dkv<__nv_bfloat16, 64>(a, f, st);
  return d == 128 ? launch_dkv<__half, 128>(a, f, st) : launch_dkv<__half, 64>(a, f, st);
}
