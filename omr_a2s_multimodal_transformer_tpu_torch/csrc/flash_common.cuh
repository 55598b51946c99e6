// Shared pieces of the head-packed flash attention kernels (flash_fwd.cu,
// flash_bwd.cu, flash_dq.cu, flash_dkv.cu) and of the any-dtype legacy
// kernels (legacy_flash_any_*.cu): tile geometry, bf16 mma.sync helpers,
// cp.async groups, the key test (its band half in flash_band.h) and the
// dropout keep-mask hash (whose arithmetic K4, keep_mask.cu, re-derives).
//
// Layout: q/o/do are [B, Lq, H*64] bf16 and k/v are [B, Lk, H*64] bf16,
// contiguous. A block works on one head: it indexes head h's 64 columns of
// the packed rows directly (the TPU kernel's block-diagonal packing existed
// only to fill 128-lane tiles and has no counterpart here). The per-head
// legacy kernels that share K1's, K3a's and K3b's blocks (L1, L2a, L2b,
// L2c) take [B, H, L, D] tensors instead (tile_at, row_offset).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_band.h"

namespace flash {

constexpr int DH = 64;         // head dim
constexpr int NWARP = 4;       // each warp owns 16 rows of a 64-row tile
constexpr int NT = NWARP * 32;
constexpr float NEG_INF = -1e30f;  // the masked-score substitute of the TPU kernel
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

typedef __nv_bfloat16 bf16;

// D += A(16x16, row) * B(16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two floats -> one register of two bf16 (lo in the low half).
__device__ __forceinline__ uint32_t pack_f2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8. Register j holds matrix j in the mma fragment
// layout (row lane / 4, columns 2 * (lane % 4) and +1); .trans transposes
// each matrix on the way.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// 2^x on the special-function unit (about 2 ulp; p is rounded to bf16 later).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The key test of every kernel (JAX _row_mask, ops/flash_packed.py:63-73):
// query q sees key k when k < kv_len[b], kv_valid[b, k] and, for a causal
// call, k <= q and (window > 0 only) k >= q - window. key_valid is the
// first half, read once per key tile; in_band (flash_band.h) the second.
__device__ __forceinline__ bool key_valid(const uint8_t* valid_b, int len, int k) {
  return k < len && valid_b[k] != 0;
}

// Where head h of batch row b lies in a tensor map (the column of its first
// 64-column box, the map's batch index): a head-packed [B, L, H*64] tensor
// is a map of (H*64 columns, L rows, B), a per-head [B, H, L, D] one a map
// of (D columns, L rows, B*H).
template <bool PER_HEAD>
__device__ __forceinline__ int2 tile_at(int b, int h, int H) {
  return PER_HEAD ? make_int2(0, b * H + h) : make_int2(h * DH, b);
}

// The element offset of row `row` of head h, batch row b, in a
// [B, L, H*64] (head-packed) or [B, H, L, D] (per-head) tensor.
template <bool PER_HEAD>
__device__ __forceinline__ size_t row_offset(int b, int h, int H, int L, int D, int row) {
  return PER_HEAD ? (((size_t)b * H + h) * L + row) * D : ((size_t)b * L + row) * (H * DH) + h * DH;
}

// Dropout keep-mask, bit-identical to the counter hash of the JAX kernel's
// interpret mode (omr_a2s_multimodal_transformer_tpu/ops/flash_packed.py
// _keep_mask): per (batch, q-block, k-block) of the JAX mask geometry
// (mbq, mbk), mix = seed ^ b*1000003 ^ qi*7919 ^ kb*104729 (int32 wrap),
// x = mix*2654435761 ^ row*40503 ^ col*2246822519 (uint32 wrap) with
// row = h*mbq + q % mbq and col = k % mbk, then the murmur3 finalizer
// (x ^= x >> 16; x *= 0x85EBCA6B; x ^= x >> 13; x *= 0xC2B2AE35;
// x ^= x >> 16). Keep where x >= thresh = floor(rate * 2^32).
constexpr uint32_t ROW_MUL = 40503u;
constexpr uint32_t COL_MUL = 2246822519u;
constexpr uint32_t FMIX_MUL1 = 0x85EBCA6Bu;
constexpr uint32_t FMIX_MUL2 = 0xC2B2AE35u;

__device__ __forceinline__ uint32_t block_mix(int seed, int b, int qi, int kb) {
  const uint32_t mix = (uint32_t)seed ^ ((uint32_t)b * 1000003u) ^ ((uint32_t)qi * 7919u) ^
                       ((uint32_t)kb * 104729u);
  return mix * 2654435761u;
}

// The finalizer split after its first step, for kernels that hoist that
// step: for x = a ^ c, x ^ (x >> 16) = fold16(a) ^ fold16(c), so the row
// and the column terms are each folded once (K1, K2, K3a, K3b, K4), and the
// keep bit of x is keep_bit_folded(fold16(a) ^ fold16(c)).
__device__ __forceinline__ uint32_t fold16(uint32_t x) { return x ^ (x >> 16); }

__device__ __forceinline__ bool keep_bit_folded(uint32_t x, uint32_t thresh) {
  x *= FMIX_MUL1;
  x ^= x >> 13;
  x *= FMIX_MUL2;
  x ^= x >> 16;
  return x >= thresh;
}

}  // namespace flash
