// Shared helpers of the port's CUDA kernels: dtype codes (kept in step with
// DTYPE_CODES in _build.py) and scalar conversions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

enum XfaDtype : int {
  XFA_BF16 = 0,
  XFA_I8 = 1,
  XFA_FP8_E4M3 = 2,
  XFA_F16 = 3,
  XFA_F32 = 4,
};

// fp8-e4m3 travels as its raw byte; conversions go through cuda_fp8.h
struct fp8e4m3_t {
  uint8_t x;
};

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_float(fp8e4m3_t v) {
  __half_raw h = __nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(v.x), __NV_E4M3);
  return __half2float(__half(h));
}

// a float rounded (to nearest even) to the 16-bit type T, and a pair of them
// packed into one word, the first in the low half
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const T a = from_float<T>(lo), b = from_float<T>(hi);
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&a)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&b)) << 16);
}
// the two 16-bit T values of a word as floats
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t w) {
  const uint16_t lo = static_cast<uint16_t>(w & 0xFFFFu), hi = static_cast<uint16_t>(w >> 16);
  return make_float2(to_float(*reinterpret_cast<const T*>(&lo)),
                     to_float(*reinterpret_cast<const T*>(&hi)));
}

// Packed conversions of the bytes 0 and 2 of a word into a bf16 pair (the
// first in the low half), exact for every value: every int8 and every e4m3
// value is a bf16 value (qmm.cu's weights, paged_attention.cu's K/V pools).
// The f16 pairs below are exact too: every int8 and every e4m3 value is an
// f16 value. x2_from_bytes02<T> picks the pair type of the product.

// int8: a = 128 + the low 7 bits (bf16 0x4300 | bits), c = 128, or 256 where
// the sign bit is set, and x = a - c.
__device__ __forceinline__ uint32_t bf16x2_from_bytes02(int8_t, uint32_t v) {
  const uint32_t a = (v & 0x007F007Fu) | 0x43004300u;
  const uint32_t c = (v & 0x00800080u) | 0x43004300u;
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(c));
  return d;
}

// e4m3 (s eeee mmm): the fields moved into a bf16 (s, exponent e, mantissa
// m << 4), which is the value times 2^-120, then one bf16 product by 2^120
// (0x7B80), exact for the subnormal e = 0 too.
__device__ __forceinline__ uint32_t bf16x2_from_bytes02(fp8e4m3_t, uint32_t v) {
  const uint32_t b = ((v & 0x007F007Fu) << 4) | ((v & 0x00800080u) << 8);
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(b), "r"(0x7B807B80u));
  return d;
}

// The same into an f16 pair. int8: a = 1024 + the low 7 bits (f16 0x6400 |
// bits, ulp 1 in [1024, 2048)), c = 1024, or 1152 where the sign bit is set,
// and x = a - c.
__device__ __forceinline__ uint32_t f16x2_from_bytes02(int8_t, uint32_t v) {
  const uint32_t a = (v & 0x007F007Fu) | 0x64006400u;
  const uint32_t c = (v & 0x00800080u) | 0x64006400u;
  uint32_t d;
  asm("sub.rn.f16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(c));
  return d;
}

// e4m3: the fields moved into an f16 (s, exponent e, mantissa m << 7), which
// is the value times 2^-8 (the biases 15 and 7), then one f16 product by 2^8
// (0x5C00), exact for the subnormal e = 0 too.
__device__ __forceinline__ uint32_t f16x2_from_bytes02(fp8e4m3_t, uint32_t v) {
  const uint32_t b = ((v & 0x007F007Fu) << 7) | ((v & 0x00800080u) << 8);
  uint32_t d;
  asm("mul.rn.f16x2 %0, %1, %2;\n" : "=r"(d) : "r"(b), "r"(0x5C005C00u));
  return d;
}

template <typename T, typename KV>
__device__ __forceinline__ uint32_t x2_from_bytes02(uint32_t v) {
  if constexpr (std::is_same<T, __half>::value)
    return f16x2_from_bytes02(KV{}, v);
  else
    return bf16x2_from_bytes02(KV{}, v);
}
