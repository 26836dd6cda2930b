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

// max over the block; every thread gets the result. blockDim.x must be a
// multiple of 32 and at most 1024.
__device__ __forceinline__ float block_max(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  const int n_warps = blockDim.x >> 5;
  float r = scratch[0];
  for (int w = 1; w < n_warps; ++w) r = fmaxf(r, scratch[w]);
  __syncthreads();  // scratch may be reused right after
  return r;
}
