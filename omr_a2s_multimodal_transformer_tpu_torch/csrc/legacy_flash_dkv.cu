// L2c: dk and dv of the per-head flash attention backward.
//
// Replaces tools/legacy_flash/flash_attention_bwd.py _dkv_kernel (:150,
// pallas_call :360; windowed query range :161-166), which the JAX backward
// runs after _dq_kernel. Per (b, h), with scale = 1/sqrt(D), p = exp(s *
// scale - lse) on the keys each query sees (0 elsewhere; the key test of
// L2a) and delta = rowsum(do * o) computed by the caller:
//   dp = do v^T,  ds = p * (dp - delta) * scale,  dv = p^T do,  dk = ds^T q
// p and ds are rounded to bf16 before their products (the JAX kernel keeps
// them in f32). The TPU kernel carried dk/dv in VMEM across its sequential
// query-block axis; here a block walks the query tiles in a loop.
//
// What bounds it on the H100: four products, 8*D FLOP per (query, key)
// pair a query sees. At the cross shape tensor-core FLOPs bound it, and
// the CUDA cores (an exp and ds per score) set the pace first. In a
// windowed causal call at W = 100 a key is seen by at most 101 queries:
// bytes bound it.
//
// The design is K3b's block (K2's without dq, flash_bwd.cuh) on the
// per-head layout, with no dropout (the hash is compiled out) and the
// caller's scale: a block per (128 keys, head, batch row), a producer warp
// feeding a 3-stage TMA ring of 64-query Q and dO tiles and their (lse *
// log2 e, delta) pairs to two consumer warpgroups of 64 keys that run
// s^T, dp^T, dv += p^T do and dk += ds^T q on wgmma; a causal call walks
// only the query tiles that may see the block's keys, and a warpgroup
// whose 64 keys are all invalid runs no product. [B, H, L, D] tensors are
// read through maps of (D columns, L rows, B*H), whose zero fill gives the
// columns past D and the rows past L; a head of 64 < D <= 128 is two
// 64-column boxes a row, with dk and dv in two 64 x 64 accumulators each
// (128 registers a thread of the consumers' 240). dk and dv are written
// once: no atomics, bitwise deterministic.
#include "flash_bwd.cuh"

using namespace flash;

// grid (ceil(Lk / 128), H, B); NB boxes of 64 columns a row.
template <bool CAUSAL, int NB>
__global__ void __launch_bounds__(k2::THREADS, 1)
lf_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
              const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
              const int* __restrict__ kv_len, const uint8_t* __restrict__ kv_valid, const float* __restrict__ stats,
              bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Lq, int Lk, int D, int window, float scale) {
  k2::bwd_block<false, CAUSAL, true, NB, false>(&tq, &tdo, &tk, &tv, nullptr, kv_len, kv_valid, nullptr, stats, dk,
                                                dv, H, Lq, Lk, D, BQ, BK, window, scale, 0.f, 1.f, 0u);
}

template <bool CAUSAL, int NB>
static int launch_dkv(const CUtensorMap& tq, const CUtensorMap& tdo, const CUtensorMap& tk, const CUtensorMap& tv,
                      const void* kv_len, const void* kv_valid, const void* stats, void* dk, void* dv, int B, int H,
                      int Lq, int Lk, int D, int window, float scale, cudaStream_t st) {
  auto kernel = &lf_dkv_kernel<CAUSAL, NB>;
  constexpr int smem = k2::smem_bytes<false, NB>();
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Lk + k2::KEYS - 1) / k2::KEYS, H, B);
  kernel<<<grid, k2::THREADS, smem, st>>>(tq, tdo, tk, tv, (const int*)kv_len, (const uint8_t*)kv_valid,
                                          (const float*)stats, (bf16*)dk, (bf16*)dv, H, Lq, Lk, D, window, scale);
  return (int)cudaGetLastError();
}

// [B, H, L, D] bf16 with D % 8 == 0, D <= 128 and 16-byte aligned bases;
// stats is [B, H, ceil(Lq / 64) * 64, 2] f32: (lse * log2 e, delta), zero
// past Lq.
extern "C" int lf_dkv_launch(const void* q, const void* k, const void* v, const void* kv_len, const void* kv_valid,
                             const void* dout, const void* stats, void* dk, void* dv, int B, int H, int Lq, int Lk,
                             int D, int causal, int window, float scale, void* stream) {
  if (D <= 0 || D > 128 || D % 8) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tdo, tk, tv;
  const int err = hopper::make_qkv_maps(&tq, &tdo, &tk, &tv, q, dout, k, v, B * H, Lq, Lk, D);
  if (err) return err;
  auto go = [&](auto launch) {
    return launch(tq, tdo, tk, tv, kv_len, kv_valid, stats, dk, dv, B, H, Lq, Lk, D, window, scale,
                  (cudaStream_t)stream);
  };
  if (D <= 64) return causal ? go(&launch_dkv<true, 1>) : go(&launch_dkv<false, 1>);
  return causal ? go(&launch_dkv<true, 2>) : go(&launch_dkv<false, 2>);
}
