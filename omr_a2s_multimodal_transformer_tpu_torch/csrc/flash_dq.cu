// K3a: dq of the split flash attention backward.
//
// Replaces omr_a2s_multimodal_transformer_tpu/ops/flash_packed.py
// _dq_kernel (:228), which the JAX backward runs, before _dkv_kernel, for
// every causal, windowed or merged_bwd=False call (:581). Per head h, with
// p = exp(s - lse) on the keys the query may see (0 elsewhere), M the
// dropout keep-mask regenerated from the forward's hash and
// delta = rowsum(do * o) per (b, h, q) computed by the caller:
//   dp = (do v^T) * M / (1 - rate),  ds = p * (dp - delta) / 8,  dq = ds k
// ds is rounded to bf16 before its product, as in the TPU kernel.
//
// What bounds it on the H100: three products, 6*H*64 FLOP per (query, key)
// pair the query sees (0.17 ms non-causal at the cross shape); the CUDA
// cores set the pace first, with an exp, the ds arithmetic and, with
// dropout, the keep-mask hash per score. At the paper's window (100) each
// query sees at most 101 keys against 768 bytes of q, k, v, do and dq per
// query and head, so bytes bound it. The design is K1's layout
// (flash_fwd.cu) with the backward's arithmetic, in a block that L2b
// (legacy_flash_dq.cu) shares for the per-head layout (flash_dq.cuh):
// - a block per (NCONS x 64 queries, head, batch row, key chunk) of
//   NCONS + 1 warpgroups (3 for a non-causal call, 2 for a causal one,
//   whose band is short): a producer (one warp: a thread issues TMA loads of
//   128-byte-swizzled 64 x 64 tiles, the block's Q and dO tiles once, then a
//   4-stage K/V ring guarded by mbarriers; the lanes write each key tile's
//   key test as a 64-bit mask and, with dropout, the first step of the hash
//   folded into its column terms, fold16) and NCONS consumer warpgroups of
//   64 queries each that share the K/V tiles; setmaxnreg moves the
//   producer's registers to them. Each consumer holds lse * log2 e and
//   delta for its rows;
// - per key tile, s = q k^T and dp = do v^T on wgmma from shared memory,
//   the keep-mask hash of that tile while both are in flight, then p and ds
//   in f32, and dq += ds k on wgmma with ds (bf16) as the register A
//   operand (the accumulator layout re-used as the A fragment) and k read
//   MN-major. dq += ds k of tile i and s, dp of tile i + 1 are in flight
//   together; every product is retired inside its loop iteration;
// - no wave tail: a non-causal call splits its key tiles into chunks
//   (chosen by the wrapper for the SM count, dq_splits), each writing an
//   f32 dq partial; a second kernel sums the partials in chunk order and
//   rounds to bf16. No atomics: dq is bitwise deterministic. A causal call
//   walks the key tiles of its band (key_tiles) in one chunk and tests each
//   score against the band;
// - a key tile with no valid key (kv_valid, kv_len: the ragged images'
//   memories hold 8% of such tiles) runs no product.
// The accumulator layout gives each thread query rows 16w + g and + 8 and
// key pairs 8j + 2t, K1's frame, so the hoisted hash terms and the
// keep-mask are the forward's bit for bit.
#include "flash_dq.cuh"

using namespace flash;

// grid (ceil(Lq / (64 NCONS)), H, B * n_split); k3a::dq_block on the
// head-packed layout at head width 64 (scale 1/8), with dropout.
template <int NCONS, bool CAUSAL>
__global__ void __launch_bounds__(128 * (NCONS + 1), 1)
flash_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                const int* __restrict__ kv_len, const uint8_t* __restrict__ kv_valid, const int* __restrict__ seed_p,
                const float* __restrict__ stats, bf16* __restrict__ dq, float* __restrict__ dq_part, int B, int H,
                int Lq, int Lk, int mbq, int mbk, int window, int n_split, int per, float rate, float keep_scale,
                uint32_t thresh) {
  k3a::dq_block<NCONS, CAUSAL, false, 1, true>(&tq, &tdo, &tk, &tv, kv_len, kv_valid, seed_p, stats, dq, dq_part, B,
                                               H, Lq, Lk, DH, mbq, mbk, window, n_split, per, 0.125f, rate,
                                               keep_scale, thresh);
}

// The sum of K3a's key-chunk partials in chunk order, rounded to bf16.
__global__ void __launch_bounds__(k3a::MERGE_THREADS)
flash_dq_merge_kernel(const float* __restrict__ dq_part, bf16* __restrict__ dq, size_t n4, int n_split) {
  k3a::merge_partials(dq_part, dq, n4, n_split);
}

template <int NCONS, bool CAUSAL>
static int launch_dq(const CUtensorMap& tq, const CUtensorMap& tdo, const CUtensorMap& tk, const CUtensorMap& tv,
                     const void* kv_len, const void* kv_valid, const void* seed, const void* stats, void* dq,
                     void* dq_part, int B, int H, int Lq, int Lk, int mbq, int mbk, int window, int n_split, int per,
                     float rate, float keep_scale, unsigned int thresh, cudaStream_t st) {
  auto kernel = &flash_dq_kernel<NCONS, CAUSAL>;
  constexpr int smem = k3a::smem_bytes<NCONS, 1>();
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Lq + 64 * NCONS - 1) / (64 * NCONS), H, B * n_split);
  kernel<<<grid, 128 * (NCONS + 1), smem, st>>>(
      tq, tdo, tk, tv, (const int*)kv_len, (const uint8_t*)kv_valid, (const int*)seed, (const float*)stats, (bf16*)dq,
      (float*)dq_part, B, H, Lq, Lk, mbq, mbk, window, n_split, per, rate, keep_scale, thresh);
  return (int)cudaGetLastError();
}

// K3a. A non-causal call (3 consumer warpgroups a block) splits the keys
// into n_split chunks of `per` 64-key tiles (the wrapper's dq_splits) and,
// for n_split > 1, merges the partials from dq_part; a causal call (2
// consumer warpgroups: its band is short) takes n_split 1.
extern "C" int flash_dq_launch(const void* q, const void* k, const void* v, const void* kv_len, const void* kv_valid,
                               const void* seed, const void* dout, const void* stats, void* dq, void* dq_part, int B,
                               int H, int Lq, int Lk, int mbq, int mbk, int causal, int window, int n_split, int per,
                               float rate, float keep_scale, unsigned int thresh, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (!k3a::valid_split(Lk, causal, n_split, per, dq_part)) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tdo, tk, tv;
  int err = hopper::make_qkv_maps(&tq, &tdo, &tk, &tv, q, dout, k, v, B, Lq, Lk, H * DH);
  if (err) return err;
  auto go = [&](auto launch) {
    return launch(tq, tdo, tk, tv, kv_len, kv_valid, seed, stats, dq, dq_part, B, H, Lq, Lk, mbq, mbk, window,
                  n_split, per, rate, keep_scale, thresh, st);
  };
  err = causal ? go(&launch_dq<2, true>) : go(&launch_dq<3, false>);
  if (err || n_split == 1) return err;
  const size_t n4 = (size_t)B * Lq * H * DH / 4;
  flash_dq_merge_kernel<<<(unsigned)((n4 + k3a::MERGE_THREADS - 1) / k3a::MERGE_THREADS), k3a::MERGE_THREADS, 0,
                          st>>>((const float*)dq_part, (bf16*)dq, n4, n_split);
  return (int)cudaGetLastError();
}
