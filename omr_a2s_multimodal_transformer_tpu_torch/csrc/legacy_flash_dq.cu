// L2b: dq of the per-head flash attention backward.
//
// Replaces tools/legacy_flash/flash_attention_bwd.py _dq_kernel (:109,
// pallas_call :328), which the JAX backward runs before _dkv_kernel. Per
// (b, h), with scale = 1/sqrt(D), p = exp(s * scale - lse) on the keys the
// query sees (0 elsewhere; the key test of L2a) and delta = rowsum(do * o)
// computed by the caller:
//   dp = do v^T,  ds = p * (dp - delta) * scale,  dq = ds k
// ds is rounded to bf16 before its product (the JAX kernel keeps it in
// f32). The TPU kernel carried dq in VMEM across its sequential key-block
// axis; here a block walks the key tiles in a loop.
//
// What bounds it on the H100: three products, 6*D FLOP per (query, key)
// pair a query sees. At the cross shape that is far above the ~295
// FLOP/byte balance point (tensor-core FLOPs bound it, the CUDA cores set
// the pace first: an exp and the ds arithmetic per score). In a windowed
// causal call at W = 100 bytes bound it.
//
// The design is K3a's block (flash_dq.cuh) on the per-head layout, with no
// dropout (the hash is compiled out) and the caller's scale: a producer
// warp feeding a 4-stage TMA ring of 64-key K and V tiles to consumer
// warpgroups of 64 queries, s, dp and dq += ds k on wgmma, no product on a
// key tile with no valid key. [B, H, L, D] tensors are read through maps
// of (D columns, L rows, B*H), whose zero fill gives the columns past D and
// the rows past L; heads come in two width classes:
// - D <= 64: one 64-column box a row, 3 consumer warpgroups (2 for a causal
//   call), as K3a;
// - 64 < D <= 128: two boxes a row, dq in two 64 x 64 accumulators, 2
//   consumer warpgroups (with three, 160 registers a thread would not hold
//   dq's 64 floats beside s and dp; 2 x 64 KB of Q and dO and a 4-stage ring
//   of 64 KB stages fill 193 KB of shared memory).
// A non-causal call walks its key tiles in n_split chunks of `per` (the
// wrapper's legacy_dq_splits), each writing an f32 partial that a second
// kernel sums in chunk order; a causal call walks its band in one. No
// atomics: dq is bitwise deterministic.
#include "flash_dq.cuh"

using namespace flash;

// grid (ceil(Lq / (64 NCONS)), H, B * n_split); NB boxes of 64 columns a row.
template <int NCONS, bool CAUSAL, int NB>
__global__ void __launch_bounds__(128 * (NCONS + 1), 1)
lf_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
             const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
             const int* __restrict__ kv_len, const uint8_t* __restrict__ kv_valid, const float* __restrict__ stats,
             bf16* __restrict__ dq, float* __restrict__ dq_part, int B, int H, int Lq, int Lk, int D, int window,
             int n_split, int per, float scale) {
  k3a::dq_block<NCONS, CAUSAL, true, NB, false>(&tq, &tdo, &tk, &tv, kv_len, kv_valid, nullptr, stats, dq, dq_part, B,
                                                H, Lq, Lk, D, BQ, BK, window, n_split, per, scale, 0.f, 1.f, 0u);
}

// The sum of L2b's key-chunk partials in chunk order, rounded to bf16.
__global__ void __launch_bounds__(k3a::MERGE_THREADS)
lf_dq_merge_kernel(const float* __restrict__ dq_part, bf16* __restrict__ dq, size_t n4, int n_split) {
  k3a::merge_partials(dq_part, dq, n4, n_split);
}

template <int NCONS, bool CAUSAL, int NB>
static int launch_dq(const CUtensorMap& tq, const CUtensorMap& tdo, const CUtensorMap& tk, const CUtensorMap& tv,
                     const void* kv_len, const void* kv_valid, const void* stats, void* dq, void* dq_part, int B,
                     int H, int Lq, int Lk, int D, int window, int n_split, int per, float scale, cudaStream_t st) {
  auto kernel = &lf_dq_kernel<NCONS, CAUSAL, NB>;
  constexpr int smem = k3a::smem_bytes<NCONS, NB>();
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Lq + 64 * NCONS - 1) / (64 * NCONS), H, B * n_split);
  kernel<<<grid, 128 * (NCONS + 1), smem, st>>>(tq, tdo, tk, tv, (const int*)kv_len, (const uint8_t*)kv_valid,
                                                (const float*)stats, (bf16*)dq, (float*)dq_part, B, H, Lq, Lk, D,
                                                window, n_split, per, scale);
  return (int)cudaGetLastError();
}

// [B, H, L, D] bf16 with D % 8 == 0, D <= 128 and 16-byte aligned bases;
// stats is [B, H, ceil(Lq / 64) * 64, 2] f32: (lse * log2 e, delta). A
// non-causal call splits the key tiles into n_split chunks of `per` and,
// for n_split > 1, merges the partials from dq_part ([n_split, B, H, Lq, D]
// f32); a causal call takes n_split 1.
extern "C" int lf_dq_launch(const void* q, const void* k, const void* v, const void* kv_len, const void* kv_valid,
                            const void* dout, const void* stats, void* dq, void* dq_part, int B, int H, int Lq, int Lk,
                            int D, int causal, int window, int n_split, int per, float scale, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (D <= 0 || D > 128 || D % 8 || !k3a::valid_split(Lk, causal, n_split, per, dq_part))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tdo, tk, tv;
  int err = hopper::make_qkv_maps(&tq, &tdo, &tk, &tv, q, dout, k, v, B * H, Lq, Lk, D);
  if (err) return err;
  auto go = [&](auto launch) {
    return launch(tq, tdo, tk, tv, kv_len, kv_valid, stats, dq, dq_part, B, H, Lq, Lk, D, window, n_split, per, scale,
                  st);
  };
  if (D <= 64)
    err = causal ? go(&launch_dq<2, true, 1>) : go(&launch_dq<3, false, 1>);
  else
    err = causal ? go(&launch_dq<2, true, 2>) : go(&launch_dq<2, false, 2>);
  if (err || n_split == 1) return err;
  const size_t n4 = (size_t)B * H * Lq * D / 4;
  lf_dq_merge_kernel<<<(unsigned)((n4 + k3a::MERGE_THREADS - 1) / k3a::MERGE_THREADS), k3a::MERGE_THREADS, 0, st>>>(
      (const float*)dq_part, (bf16*)dq, n4, n_split);
  return (int)cudaGetLastError();
}
