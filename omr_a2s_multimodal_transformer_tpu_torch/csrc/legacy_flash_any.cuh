// Shared pieces of the legacy flash kernels for any float type and head
// width (legacy_flash_any_fwd.cu; the backward's dq and dk/dv add
// legacy_flash_any_bwd.cuh): the route of tools/legacy_flash that the bf16
// tensor-core templates (legacy_flash_*.cu, D <= 128) do not take, that is
// float16, float32, and heads of any width. The element conversions and the
// dtype dispatch serve all three.
//
// Layout as there: q/o/do [B, H, Lq, D], k/v/dk/dv [B, H, Lk, D] of one type
// T (bf16, f16 or f32), contiguous; lse and delta [B, H, Lq] f32. In the
// forward one warp owns one query row and computes in float32 on the CUDA
// cores: each lane scores one of 32 keys at a time, then the warp
// accumulates its D-wide output in shared memory, lane d owning columns d,
// d + 32, ... So D is a runtime width: a warp keeps a few rows of D floats
// in shared memory, and a block runs as many warps (up to 4) as those fit.
// No caller of the port runs float32 or wide heads; the forward favours
// simplicity over speed.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lfany {

constexpr float NEG_INF = -1e30f;
constexpr int MAX_WARPS = 4;
constexpr int SMEM_LIMIT = 227 * 1024;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

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

// The key test of JAX _mask (flash_attention_bwd.py:43-51): k < kv_len,
// kv_valid[b, k] (when given), and for a causal call k <= q and (window > 0)
// k >= q - window.
__device__ __forceinline__ bool key_ok(const uint8_t* valid_b, int len, int k) {
  return k < len && (valid_b == nullptr || valid_b[k] != 0);
}

__device__ __forceinline__ bool in_band(bool causal, int window, int q, int k) {
  return !causal || (k <= q && (window <= 0 || k >= q - window));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// dot(a (shared, f32), b (global, T)) over D columns, by one lane.
template <typename T>
__device__ __forceinline__ float dot_row(const float* a, const T* b, int D) {
  float acc = 0.f;
  for (int d = 0; d < D; ++d) acc = fmaf(a[d], to_f(b[d]), acc);
  return acc;
}

// Warps per block for `floats_per_warp` shared floats a warp (0: too wide).
inline int warps_for(int floats_per_warp) {
  const long bytes = (long)floats_per_warp * 4;
  const long w = SMEM_LIMIT / bytes;
  return (int)(w < MAX_WARPS ? w : MAX_WARPS);
}

// Opt in to the shared memory, then launch `rows` warps.
template <typename Kernel, typename... Args>
int launch_rows(Kernel kernel, long rows, int floats_per_warp, void* stream, Args... args) {
  const int warps = warps_for(floats_per_warp);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const int smem = warps * floats_per_warp * 4;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long blocks = (rows + warps - 1) / warps;
  if (blocks < 1) return 0;
  kernel<<<(unsigned)blocks, warps * 32, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

// The dtype code of the launch functions: 0 bf16, 1 f16, 2 f32.
#define LFANY_DISPATCH(dtype, FN, ...)                                      \
  (dtype) == 0 ? FN<__nv_bfloat16>(__VA_ARGS__)                             \
               : (dtype) == 1 ? FN<__half>(__VA_ARGS__)                     \
                              : (dtype) == 2 ? FN<float>(__VA_ARGS__) : (int)cudaErrorInvalidValue

}  // namespace lfany
