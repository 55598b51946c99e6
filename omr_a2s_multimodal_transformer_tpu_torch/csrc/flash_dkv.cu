// K3b: dk and dv of the split flash attention backward.
//
// Replaces omr_a2s_multimodal_transformer_tpu/ops/flash_packed.py
// _dkv_kernel (:283; windowed query range :296-301), which the JAX backward
// runs after _dq_kernel for every causal, windowed or merged_bwd=False call
// (:581). Per head h, with p = exp(s - lse) on the keys each query may see
// (0 elsewhere), M the dropout keep-mask regenerated from the forward's hash
// and delta = rowsum(do * o) per (b, h, q) computed by the caller, and the
// dropout handling of :316-325 (dv takes the dropped p, ds the undropped p
// with the dropped dp):
//   dp = (do v^T) * M / (1 - rate),  ds = p * (dp - delta) / 8
//   dv = (p * M / (1 - rate))^T do,  dk = ds^T q
//
// What bounds it on the H100: four products, 8*H*64 FLOP per (query, key)
// pair a query sees. Non-causal at the cross shape, tensor-core FLOPs bound
// it (0.23 ms), and the CUDA cores (exp, ds, the keep-mask hash) set the
// pace first. At the paper's window (100) a key is seen by at most 101
// queries against 768 bytes of q, k, v, do, dk and dv per key and head:
// bytes bound it.
//
// The design is K2's block without dq (flash_bwd.cuh, DQ = false): a block
// per (128 keys, head, batch row), a producer warp feeding a 3-stage TMA
// ring of Q and dO tiles and their (lse * log2 e, delta) pairs, two
// consumer warpgroups of 64 keys that run s^T, dp^T, dv += p_drop^T do and
// dk += ds^T q on wgmma with the keep-mask hash in flight. A causal call
// walks only the query tiles that may see the block's keys and tests each
// score against the band. dk and dv accumulate in registers and are
// written once: no atomics, bitwise deterministic.
#include "flash_bwd.cuh"

using namespace flash;

// grid (ceil(Lk / 128), H, B); stats as K2's.
template <bool CAUSAL>
__global__ void __launch_bounds__(k2::THREADS, 1)
flash_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                 const int* __restrict__ kv_len, const uint8_t* __restrict__ kv_valid, const int* __restrict__ seed_p,
                 const float* __restrict__ stats, bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Lq, int Lk,
                 int mbq, int mbk, int window, float rate, float keep_scale, uint32_t thresh) {
  k2::bwd_block<false, CAUSAL>(&tq, &tdo, &tk, &tv, nullptr, kv_len, kv_valid, seed_p, stats, dk, dv, H, Lq, Lk,
                               mbq, mbk, window, rate, keep_scale, thresh);
}

extern "C" int flash_dkv_launch(const void* q, const void* k, const void* v, const void* kv_len,
                                const void* kv_valid, const void* seed, const void* dout, const void* stats, void* dk,
                                void* dv, int B, int H, int Lq, int Lk, int mbq, int mbk, int causal, int window,
                                float rate, float keep_scale, unsigned int thresh, void* stream) {
  CUtensorMap tq, tdo, tk, tv;
  const int err = hopper::make_qkv_maps(&tq, &tdo, &tk, &tv, q, dout, k, v, B, Lq, Lk, H * DH);
  if (err) return err;
  auto kernel = causal ? &flash_dkv_kernel<true> : &flash_dkv_kernel<false>;
  static bool configured[2] = {false, false};
  if (!configured[causal ? 1 : 0]) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, k2::smem_bytes<false>());
    if (e != cudaSuccess) return (int)e;
    configured[causal ? 1 : 0] = true;
  }
  dim3 grid((Lk + k2::KEYS - 1) / k2::KEYS, H, B);
  kernel<<<grid, k2::THREADS, k2::smem_bytes<false>(), (cudaStream_t)stream>>>(
      tq, tdo, tk, tv, (const int*)kv_len, (const uint8_t*)kv_valid, (const int*)seed, (const float*)stats, (bf16*)dk,
      (bf16*)dv, H, Lq, Lk, mbq, mbk, window, rate, keep_scale, thresh);
  return (int)cudaGetLastError();
}
