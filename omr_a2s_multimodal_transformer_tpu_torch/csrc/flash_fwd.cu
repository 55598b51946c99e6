// K1 / K1c: head-packed flash attention forward with attention-weight
// dropout, non-causal (K1) or causal with an optional window (K1c).
//
// Replaces omr_a2s_multimodal_transformer_tpu/ops/flash_packed.py
// _fwd_kernel, launched from make_flash_attention_packed._fwd_impl: K1 is
// its non-causal call (the decoder's cross-attention), K1c its call with
// causal=True and window (:177-185). Per head h:
//   o   = (softmax(q k^T / 8) * M / (1 - p)) v,   M = dropout keep-mask
//   lse = log-sum-exp of the masked scores (f32, [B, H, Lq])
// keys masked where !kv_valid[b, k] or k >= kv_len[b], and for K1c where
// k > q or k < q - window (score -> -1e30).
//
// Both are built for Hopper on the block of flash_fwd.cuh, which L1 and
// L2a (legacy_flash_fwd.cu) share for the per-head layout: a producer warp
// feeding a 4-stage TMA ring of 64-key K/V tiles, with each key tile's
// mask as an additive 0 / -1e30 bias and the hash's column terms folded
// once a tile, to consumer warpgroups of 64 queries (setmaxnreg), both
// products on wgmma.
//
// K1 (flash_fwd_tma_kernel, then flash_fwd_tma_merge_kernel when the keys
// are split). What bounds it on the H100: the two products, 4*B*H*Lq*Lk*64
// FLOP (0.11 ms at the flagship cross shape), against ~5e8 scores that
// each cost an exp on the special-function units (~0.14 ms) and, with
// dropout, the keep-mask hash on the integer pipes (~10 ALU operations a
// score, ~0.3 ms): the CUDA cores, not the tensor cores, set its floor.
// Three consumer warpgroups rather than two: while one runs its softmax and
// hash on the CUDA cores, the others' products and waits fill the SM, and
// three were faster than two at dropout 0.1 on the H100. No wave tail: one
// block fills an SM, so the key tiles are split into a few chunks (chosen
// by the wrapper for the SM count, fwd_splits) whose partial (o, lse) a
// merge kernel combines by lse.
//
// K1c (flash_fwd_causal_tma_kernel): the same block with the causal band
// and K1's three consumers (k1c_plan.h k1c::CONSUMERS; two ran 13-15%
// slower at the paper's window on the H100, 6% slower at full causal). A
// block walks the 64-key tiles of its queries' band in one chunk (key_tiles),
// each consumer runs the products of the tiles in the band of its own 64
// queries (tile_meets_band), and each score is tested against the band
// (in_band). The TPU kernel skipped whole JAX blocks (_window_blocks); the
// per-score key test makes both give the same o and lse on every row that
// has a key to see. Its blocks form a 1-D grid (flash_fwd_causal_plan, in
// the order of k1c::block): at full causal the last query tiles, whose
// bands are longest, go first, which took a third off its time at the
// paper's self-attention shape on the H100; with a window, whose bands are
// alike, a (batch row, head)'s query tiles stay side by side.
//
// What bounds K1c on the H100: at the paper's window (100) a query sees at
// most 101 keys, ~50 FLOP a byte, so bytes bound the work (5.5 us at the
// paper's self-attention shape); the hash (6.9 logic-pipe instructions a
// score in the SASS, with a tile's share of its row terms) sets a floor of
// 1.3 us over the pairs a query sees. At full causal the hash's floor
// (9.7 us) is above the bytes' (6.1 us). What sets its time instead is
// each tile's fixed cost (the softmax and hash of 64 x 64 scores on the
// CUDA cores between the two products) over the 2-3 tiles a consumer runs
// with the window, a block's set-up and epilogue, and 1.7 waves of blocks:
// 0.021 / 0.017 ms at dropout 0.1 / 0 with the window, 0.054 ms at full
// causal (the first, mma.sync design: 0.027 / 0.023 and 0.098).
#include "flash_fwd.cuh"
#include "k1c_plan.h"

using namespace flash;

// ------------------------------------------------------------------- K1

constexpr int K1_NCONS = 3;  // consumer warpgroups of 64 queries
constexpr int K1_THREADS = 128 * (K1_NCONS + 1);
constexpr int K1_ROWS = 64 * K1_NCONS;  // queries per block

// grid (ceil(Lq / 192), H, B * n_split); k1::fwd_block on the head-packed
// layout at head width 64 (scale 1/8), with dropout. Block z = b * n_split +
// split walks key tiles [split * per, min(n_tiles, (split + 1) * per)).
// n_split == 1 writes o (bf16) and lse; otherwise the normalized partial o
// (f32, [n_split, B, Lq, H*64]) and its lse ([n_split, B, H, Lq]) for the
// merge kernel.
__global__ void __launch_bounds__(K1_THREADS, 1)
flash_fwd_tma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const int* __restrict__ kv_len,
                     const uint8_t* __restrict__ kv_valid, const int* __restrict__ seed_p, bf16* __restrict__ o,
                     float* __restrict__ lse, float* __restrict__ o_part, float* __restrict__ lse_part, int B, int H,
                     int Lq, int Lk, int mbq, int mbk, int n_split, int per, float rate, float keep_scale,
                     uint32_t thresh) {
  k1::fwd_block<K1_NCONS, false, false, 1, true, true>(k1::grid_block(n_split), &tq, &tk, &tv, kv_len, kv_valid,
                                                       seed_p, o, lse, o_part, lse_part, B, H, Lq, Lk, DH, mbq, mbk,
                                                       -1, n_split, per, 0.125f, rate, keep_scale, thresh);
}

// The merge of K1's key chunks: per (b, q, h), lse = log sum_i exp(lse_i)
// and o = sum_i exp(lse_i - lse) o_i, rounded to bf16.
__global__ void __launch_bounds__(k1::MERGE_THREADS)
flash_fwd_tma_merge_kernel(const float* __restrict__ o_part, const float* __restrict__ lse_part,
                           bf16* __restrict__ o, float* __restrict__ lse, int B, int H, int Lq, int n_split) {
  k1::merge_packed(o_part, lse_part, o, lse, B, H, Lq, n_split);
}

// -------------------------------------------------------------------- K1c

constexpr int K1C_THREADS = 128 * (k1c::CONSUMERS + 1);
constexpr int K1C_ROWS = 64 * k1c::CONSUMERS;  // queries per block
constexpr int K1C_SMEM = k1::smem_bytes<k1c::CONSUMERS, 1>();

// grid ceil(Lq / K1C_ROWS) * B * H (flash_fwd_causal_plan), block x the
// (query tile, batch row, head) of k1c::block; k1::fwd_block on the
// head-packed layout with the causal band, dropout, kv_valid and lse:
// writes o (bf16) and lse.
__global__ void __launch_bounds__(K1C_THREADS, 1)
flash_fwd_causal_tma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv, const int* __restrict__ kv_len,
                            const uint8_t* __restrict__ kv_valid, const int* __restrict__ seed_p,
                            bf16* __restrict__ o, float* __restrict__ lse, int B, int H, int Lq, int Lk, int mbq,
                            int mbk, int window, float rate, float keep_scale, uint32_t thresh) {
  k1::Block blk{0, 0, 0, 0};
  k1c::block(blockIdx.x, (Lq + K1C_ROWS - 1) / K1C_ROWS, B, H, window, blk.qt, blk.b, blk.h);
  k1::fwd_block<k1c::CONSUMERS, true, false, 1, true, true>(blk, &tq, &tk, &tv, kv_len, kv_valid, seed_p, o, lse,
                                                            nullptr, nullptr, B, H, Lq, Lk, DH, mbq, mbk, window, 1, 1,
                                                            0.125f, rate, keep_scale, thresh);
}

// K1c's launch for B batch rows, H heads and Lq queries: {threads, grid x,
// grid y, grid z (a 1-D grid of query tiles x B x H, k1c::block's order),
// dynamic shared memory bytes, consumer warpgroups}. The
// launcher launches this plan; the wrapper reads it (ops/flash_packed.py
// causal_fwd_plan) and chip_smoke.py holds the launch a trace records
// against it.
extern "C" void flash_fwd_causal_plan(int B, int H, int Lq, int* out) {
  out[0] = K1C_THREADS;
  out[1] = (Lq + K1C_ROWS - 1) / K1C_ROWS * B * H;
  out[2] = 1;
  out[3] = 1;
  out[4] = K1C_SMEM;
  out[5] = k1c::CONSUMERS;
}

// Opt a kernel in to `bytes` of dynamic shared memory on the current device,
// the tensors' (the wrapper launches under it), at every launch.
template <typename Kernel>
static int allow_smem(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// causal: K1c, on its band in one chunk (n_split 1; o_part and lse_part
// are ignored); a 64-query tile must lie inside one mask q-block and a
// 64-key tile inside one mask k-block (mbq, mbk multiples of 64), as the
// consumers hash a tile from one block_mix. Otherwise K1 with the keys in
// n_split chunks of `per` 64-key tiles (the wrapper's fwd_splits); o_part
// and lse_part are its scratch when n_split > 1.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, const void* kv_len,
                                const void* kv_valid, const void* seed, void* o, void* lse, void* o_part,
                                void* lse_part, int B, int H, int Lq, int Lk, int mbq, int mbk, int causal,
                                int window, int n_split, int per, float rate, float keep_scale, unsigned int thresh,
                                void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (!k1::valid_split(Lk, causal, n_split, per, o_part, lse_part)) return (int)cudaErrorInvalidValue;
  if (mbq % BQ || mbk % BK) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  int err = hopper::make_map_bf16(&tq, q, B, Lq, H * DH, 64);
  if (!err) err = hopper::make_map_bf16(&tk, k, B, Lk, H * DH, 64);
  if (!err) err = hopper::make_map_bf16(&tv, v, B, Lk, H * DH, 64);
  if (err) return err;
  if (causal) {
    err = allow_smem(flash_fwd_causal_tma_kernel, K1C_SMEM);
    if (err) return err;
    int plan[6];
    flash_fwd_causal_plan(B, H, Lq, plan);
    flash_fwd_causal_tma_kernel<<<dim3(plan[1], plan[2], plan[3]), plan[0], plan[4], st>>>(
        tq, tk, tv, (const int*)kv_len, (const uint8_t*)kv_valid, (const int*)seed, (bf16*)o, (float*)lse, B, H,
        Lq, Lk, mbq, mbk, window, rate, keep_scale, thresh);
    return (int)cudaGetLastError();
  }
  constexpr int K1_SMEM = k1::smem_bytes<K1_NCONS, 1>();
  err = allow_smem(flash_fwd_tma_kernel, K1_SMEM);
  if (err) return err;
  dim3 grid((Lq + K1_ROWS - 1) / K1_ROWS, H, B * n_split);
  flash_fwd_tma_kernel<<<grid, K1_THREADS, K1_SMEM, st>>>(
      tq, tk, tv, (const int*)kv_len, (const uint8_t*)kv_valid, (const int*)seed, (bf16*)o, (float*)lse,
      (float*)o_part, (float*)lse_part, B, H, Lq, Lk, mbq, mbk, n_split, per, rate, keep_scale, thresh);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return (int)e;
  const size_t n = (size_t)B * Lq * H * 16;
  flash_fwd_tma_merge_kernel<<<(unsigned)((n + k1::MERGE_THREADS - 1) / k1::MERGE_THREADS), k1::MERGE_THREADS, 0,
                               st>>>(
      (const float*)o_part, (const float*)lse_part, (bf16*)o, (float*)lse, B, H, Lq, n_split);
  return (int)cudaGetLastError();
}
