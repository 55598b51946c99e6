// K2: head-packed flash attention backward (dq, dk, dv in one pass).
//
// Replaces omr_a2s_multimodal_transformer_tpu/ops/flash_packed.py
// _dqkv_kernel (the merged backward of the non-causal path). Per head h,
// with p = exp(s - lse) on unmasked keys (0 elsewhere), M the dropout
// keep-mask regenerated from the same hash as the forward and
// delta = rowsum(do * o) per (b, h, q) computed by the caller:
//   dp = (do v^T) * M / (1 - rate),  ds = p * (dp - delta) / 8
//   dv = (p * M / (1 - rate))^T do,  dk = ds^T q,  dq = ds k
//
// What bounds it on the H100: five products, 10*B*H*Lq*Lk*64 FLOP (0.29 ms
// at the flagship cross shape), then the CUDA cores (an exp, ds and, with
// dropout, the keep-mask hash per score, as in the forward) and the dq
// sums across key blocks. The design (flash_bwd.cuh, whose block K3b
// shares without dq): a producer warp feeding a ring of 64-query Q and dO
// tiles by TMA to two consumer warpgroups of 64 keys each, all five
// products on wgmma in the transposed frame, the keep-mask hash in flight
// with s^T and dp^T, and dq without per-thread atomics: each warpgroup's
// 64 x 64 f32 partial is added into a f32 [B, Lq, H*64] buffer by bulk
// tensor reduce-adds. The order of those adds across key blocks changes
// from run to run, so dq is not bitwise deterministic (an f32 sum over
// ceil(Lk / 64) partials); dk and dv are written once and are.
#include "flash_bwd.cuh"

using namespace flash;

// grid (ceil(Lk / 128), H, B). stats is [B, H, ceil(Lq / 64) * 64, 2] f32:
// (lse * log2 e, delta), zero past Lq. dq_acc is the zeroed f32 [B, Lq, H*64]
// that the bulk reductions add into (map tdq).
__global__ void __launch_bounds__(k2::THREADS, 1)
flash_bwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdq, const int* __restrict__ kv_len,
                 const uint8_t* __restrict__ kv_valid, const int* __restrict__ seed_p,
                 const float* __restrict__ stats, bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Lq,
                 int Lk, int mbq, int mbk, float rate, float keep_scale, uint32_t thresh) {
  k2::bwd_block<true, false, false, 1, true>(&tq, &tdo, &tk, &tv, &tdq, kv_len, kv_valid, seed_p, stats, dk, dv, H,
                                             Lq, Lk, DH, mbq, mbk, -1, 0.125f, rate, keep_scale, thresh);
}

extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v, const void* kv_len,
                                const void* kv_valid, const void* seed, const void* dout, const void* stats,
                                void* dq_acc, void* dk, void* dv, int B, int H, int Lq, int Lk, int mbq, int mbk,
                                float rate, float keep_scale, unsigned int thresh, void* stream) {
  CUtensorMap tq, tdo, tk, tv, tdq;
  int err = hopper::make_qkv_maps(&tq, &tdo, &tk, &tv, q, dout, k, v, B, Lq, Lk, H * DH);
  if (!err) err = hopper::make_map_f32(&tdq, dq_acc, B, Lq, H * DH, 64);
  if (err) return err;
  const cudaError_t e =
      cudaFuncSetAttribute(flash_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, k2::smem_bytes<true, 1>());
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Lk + k2::KEYS - 1) / k2::KEYS, H, B);
  flash_bwd_kernel<<<grid, k2::THREADS, k2::smem_bytes<true, 1>(), (cudaStream_t)stream>>>(
      tq, tdo, tk, tv, tdq, (const int*)kv_len, (const uint8_t*)kv_valid, (const int*)seed, (const float*)stats,
      (bf16*)dk, (bf16*)dv, H, Lq, Lk, mbq, mbk, rate, keep_scale, thresh);
  return (int)cudaGetLastError();
}
