// Shared helpers of the port's CUDA kernels: dtype codes (kept in step with
// DTYPE_CODES in _build.py) and scalar conversions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

enum XfaDtype : int {
  XFA_BF16 = 0,
  XFA_I8 = 1,
  XFA_FP8_E4M3 = 2,
  XFA_F16 = 3,
};

// fp8-e4m3 travels as its raw byte; conversions go through cuda_fp8.h
struct fp8e4m3_t {
  uint8_t x;
};

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_float(fp8e4m3_t v) {
  __half_raw h = __nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(v.x), __NV_E4M3);
  return __half2float(__half(h));
}

__device__ __forceinline__ __nv_bfloat16 to_bf16(float v) { return __float2bfloat16_rn(v); }

// Packed conversions of the bytes 0 and 2 of a word into a bf16 pair (the
// first in the low half), exact for every value: every int8 and every e4m3
// value is a bf16 value (qmm.cu's weights, paged_attention.cu's K/V pools).

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
