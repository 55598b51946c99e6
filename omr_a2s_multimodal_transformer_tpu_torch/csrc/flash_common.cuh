// Shared pieces of the head-packed flash attention kernels (flash_fwd.cu,
// flash_bwd.cu, flash_dq.cu, flash_dkv.cu) and of the keep-mask probe
// (keep_mask.cu): tile geometry, bf16 mma.sync and ldmatrix helpers,
// cp.async tile loads, the key test and the dropout keep-mask hash.
//
// Layout: q/o/do are [B, Lq, H*64] bf16 and k/v are [B, Lk, H*64] bf16,
// contiguous. A block works on one head: it indexes head h's 64 columns of
// the packed rows directly (the TPU kernel's block-diagonal packing existed
// only to fill 128-lane tiles and has no counterpart here).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int DH = 64;         // head dim
constexpr int BQ = 64;         // queries per tile
constexpr int BK = 64;         // keys per tile
constexpr int NWARP = 4;       // each warp owns 16 rows of a 64-row tile
constexpr int NT = NWARP * 32;
constexpr int SROW = DH + 8;   // shared-memory row stride (bf16): 144 B, keeps ldmatrix rows off one bank
constexpr int TILE = BQ * SROW;  // elements of one 64-row tile in shared memory
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

// 16-byte asynchronous copy global -> shared; zero-fills when !pred.
__device__ __forceinline__ void cp_async16(bf16* sm, const bf16* g, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(sm)), "l"(g),
               "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying rows [row0, row0+64) of one head's 64 columns into shared
// memory, zero-filling rows at or past n_rows. g points at row 0, column h*64.
__device__ __forceinline__ void load_tile_async(bf16* sm, const bf16* g, int row0, int n_rows, int ld,
                                                int tid) {
  for (int i = tid; i < 64 * 8; i += NT) {
    const int r = i >> 3, c = (i & 7) * 8;
    const bool in = row0 + r < n_rows;
    cp_async16(sm + r * SROW + c, in ? g + (size_t)(row0 + r) * ld + c : g, in);
  }
}

// A fragments of a 16x64 row block held in shared memory (rows r0..r0+15):
// frag[kk] covers columns kk*16..kk*16+15.
__device__ __forceinline__ void load_a_frags(uint32_t (&frag)[4][4], const bf16* sm, int r0, int lane) {
  const bf16* p = sm + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * SROW + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) ldsm_x4(frag[kk], p + kk * 16);
}

// B fragments of X^T for a product A X^T, X = 8 rows (n) x 64 columns (k)
// held row-major in shared memory at rows n0..n0+7: frag[kk] = {b0, b1} of
// the 16-column chunk kk.
__device__ __forceinline__ void load_bt_frags(uint32_t (&frag)[4][2], const bf16* sm, int n0, int lane) {
  const bf16* p = sm + (n0 + (lane & 7)) * SROW + (lane >> 3) * 8;
  uint32_t r[4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    ldsm_x4(r, p + half * 32);
    frag[2 * half][0] = r[0];
    frag[2 * half][1] = r[1];
    frag[2 * half + 1][0] = r[2];
    frag[2 * half + 1][1] = r[3];
  }
}

// B fragments of X for a product A X, X = 16 rows (k) x 64 columns (n) held
// row-major in shared memory at rows k0..k0+15: frag[n] = {b0, b1} of the
// 8-column tile n.
__device__ __forceinline__ void load_b_frags(uint32_t (&frag)[8][2], const bf16* sm, int k0, int lane) {
  const bf16* p = sm + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * SROW + (lane >> 4) * 8;
  uint32_t r[4];
#pragma unroll
  for (int n = 0; n < 8; n += 2) {
    ldsm_x4_t(r, p + n * 8);
    frag[n][0] = r[0];
    frag[n][1] = r[1];
    frag[n + 1][0] = r[2];
    frag[n + 1][1] = r[3];
  }
}

// The key test of every kernel (JAX _row_mask, ops/flash_packed.py:63-73):
// query q sees key k when k < kv_len[b], kv_valid[b, k] and, for a causal
// call, k <= q and (window > 0 only) k >= q - window. key_valid is the
// first half, read once per key tile; in_band the second.
__device__ __forceinline__ bool key_valid(const uint8_t* valid_b, int len, int k) {
  return k < len && valid_b[k] != 0;
}

template <bool CAUSAL>
__device__ __forceinline__ bool in_band(int q, int k, int window) {
  return !CAUSAL || (k <= q && (window <= 0 || k >= q - window));
}

// Key tiles [lo, hi] that hold a key some query of [q0, q0 + rows) may see
// (empty when lo > hi). The skip is by 64-key tile; the key test above
// still masks each score, so the result equals the JAX block skip's.
template <bool CAUSAL>
__device__ __forceinline__ void key_tiles(int q0, int n_tiles, int window, int& lo, int& hi, int rows = BQ) {
  lo = 0;
  hi = n_tiles - 1;
  if (CAUSAL) {
    hi = min(hi, (q0 + rows - 1) / BK);
    if (window > 0) lo = max(0, q0 - window) / BK;
  }
}

// Query tiles [lo, hi] that hold a query which may see some key of
// [k0, k0 + keys).
template <bool CAUSAL>
__device__ __forceinline__ void query_tiles(int k0, int n_tiles, int window, int& lo, int& hi, int keys = BK) {
  lo = 0;
  hi = n_tiles - 1;
  if (CAUSAL) {
    lo = k0 / BQ;
    if (window > 0) hi = min(hi, (k0 + keys - 1 + window) / BQ);
  }
}

// Dropout keep-mask, bit-identical to the counter hash of the JAX kernel's
// interpret mode (omr_a2s_multimodal_transformer_tpu/ops/flash_packed.py
// _keep_mask): per (batch, q-block, k-block) of the JAX mask geometry
// (mbq, mbk), mix = seed ^ b*1000003 ^ qi*7919 ^ kb*104729 (int32 wrap),
// x = mix*2654435761 ^ row*40503 ^ col*2246822519 (uint32 wrap) with
// row = h*mbq + q % mbq and col = k % mbk, then the murmur3 finalizer.
// Keep where x >= thresh = floor(rate * 2^32). The kernels hoist the
// products: (base + i) * c = base * c + i * c with i known at compile time.
constexpr uint32_t ROW_MUL = 40503u;
constexpr uint32_t COL_MUL = 2246822519u;

__device__ __forceinline__ uint32_t block_mix(int seed, int b, int qi, int kb) {
  const uint32_t mix = (uint32_t)seed ^ ((uint32_t)b * 1000003u) ^ ((uint32_t)qi * 7919u) ^
                       ((uint32_t)kb * 104729u);
  return mix * 2654435761u;
}

// x = mixmul ^ row_term ^ col_term, finalized and compared.
__device__ __forceinline__ bool keep_bit(uint32_t x, uint32_t thresh) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= thresh;
}

// keep_bit split after its first step, for kernels that hoist that step too:
// for x = a ^ c, x ^ (x >> 16) = fold16(a) ^ fold16(c), so the row and the
// column terms are each folded once (K1, K2), and keep_bit(x) equals
// keep_bit_folded(fold16(a) ^ fold16(c)).
__device__ __forceinline__ uint32_t fold16(uint32_t x) { return x ^ (x >> 16); }

__device__ __forceinline__ bool keep_bit_folded(uint32_t x, uint32_t thresh) {
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= thresh;
}

}  // namespace flash
