// Shared pieces of the legacy flash kernels for any float type and head
// width (legacy_flash_any_fwd.cu, legacy_flash_any_dq.cu,
// legacy_flash_any_dkv.cu, all three on the tensor-core pieces of
// legacy_flash_any_bwd.cuh): the route of tools/legacy_flash that the bf16
// tensor-core templates (legacy_flash_*.cu, D <= 128, 16-byte rows) do not
// take, that is float16, float32, heads of any width and rows that are not
// 16-byte aligned. The element conversion of the stores and the dtype
// dispatch of the launch functions serve all three.
//
// Layout as there: q/o/do [B, H, Lq, D], k/v/dk/dv [B, H, Lk, D] of one type
// T (bf16, f16 or f32), contiguous; lse and delta [B, H, Lq] f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lfany {

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// The dtype code of the launch functions: 0 bf16, 1 f16, 2 f32.
#define LFANY_DISPATCH(dtype, FN, ...)                                      \
  (dtype) == 0 ? FN<__nv_bfloat16>(__VA_ARGS__)                             \
               : (dtype) == 1 ? FN<__half>(__VA_ARGS__)                     \
                              : (dtype) == 2 ? FN<float>(__VA_ARGS__) : (int)cudaErrorInvalidValue

}  // namespace lfany
