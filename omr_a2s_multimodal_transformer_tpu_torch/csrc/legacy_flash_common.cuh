// Shared pieces of the per-head legacy flash kernels on mma.sync
// (legacy_flash_any_*.cu: LA): tile geometry for a head width DP of 64 or
// 128, ldmatrix fragment loads, the key test and the tile ranges of the
// block skip. The mma.sync, ldmatrix, cp.async and ex2 primitives come from
// flash_common.cuh. L1 and L2a run on K1's TMA/wgmma block (flash_fwd.cuh),
// L2b and L2c on K3a's and K3b's (flash_dq.cuh, flash_bwd.cuh).
//
// Layout: q/o/do are [B, H, Lq, D] and k/v/dk/dv [B, H, Lk, D] bf16,
// contiguous; lse and delta are [B, H, Lq] f32. A block works on one
// (b, h) pair, whose rows are contiguous, D * 2 bytes each. The kernels are
// built for DP = 64 and 128; a head of D < DP columns (D % 8 == 0) reaches
// the template through zero-filled copies, so the padded columns add 0 to
// every product and are never stored.
#pragma once

#include "flash_common.cuh"

namespace legacy {

using flash::bf16;
using flash::BK;
using flash::BQ;
using flash::NT;

// Shared-memory row stride (bf16) of a DP-wide tile: 16 bytes of padding
// keep the eight rows an ldmatrix reads on distinct banks.
template <int DP>
struct Tile {
  static constexpr int SROW = DP + 8;
};

// A fragment of the 16-row block at rows r0.. of a tile, columns
// kk*16 .. kk*16+15 (the m16n8k16 A layout).
template <int DP>
__device__ __forceinline__ void a_frag(uint32_t (&frag)[4], const bf16* sm, int r0, int kk, int lane) {
  flash::ldsm_x4(frag, sm + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * Tile<DP>::SROW + (lane >> 4) * 8 + kk * 16);
}

// B fragments of X^T for a product A X^T, X = 8 rows (n) at n0.. of a tile:
// frag[0] covers columns c0 .. c0+15 and frag[1] c0+16 .. c0+31.
template <int DP>
__device__ __forceinline__ void bt_frags(uint32_t (&frag)[2][2], const bf16* sm, int n0, int c0, int lane) {
  uint32_t r[4];
  flash::ldsm_x4(r, sm + (n0 + (lane & 7)) * Tile<DP>::SROW + (lane >> 3) * 8 + c0);
  frag[0][0] = r[0];
  frag[0][1] = r[1];
  frag[1][0] = r[2];
  frag[1][1] = r[3];
}

// B fragments of X for a product A X, X = 16 rows (k) at k0.. of a tile:
// frag[0] covers the 8 columns from n8 * 8 and frag[1] the next 8.
template <int DP>
__device__ __forceinline__ void b_frags(uint32_t (&frag)[2][2], const bf16* sm, int k0, int n8, int lane) {
  uint32_t r[4];
  flash::ldsm_x4_t(r, sm + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * Tile<DP>::SROW + (lane >> 4) * 8 + n8 * 8);
  frag[0][0] = r[0];
  frag[0][1] = r[1];
  frag[1][0] = r[2];
  frag[1][1] = r[3];
}

// The key test of JAX _mask (flash_attention_bwd.py:43-51), in its order:
// k < kv_len[b], then (causal) k <= q, then (causal, window > 0)
// k >= q - window; L2 adds kv_valid[b, k] (valid != nullptr). key_ok is the
// part that does not depend on the query, read once per key tile; the band
// is flash::in_band.
__device__ __forceinline__ bool key_ok(const uint8_t* valid_b, int len, int k) {
  return k < len && (valid_b == nullptr || valid_b[k] != 0);
}

using flash::in_band;

// Key tiles [lo, hi] that hold a key some query of [q0, q0 + BQ) may see:
// none at or past len, none above the diagonal of a causal call, none below
// q0 - window of a windowed one (empty when lo > hi).
template <bool CAUSAL>
__device__ __forceinline__ void key_tiles(int q0, int len, int window, int& lo, int& hi) {
  lo = 0;
  hi = len > 0 ? (len - 1) / BK : -1;
  if (CAUSAL) {
    hi = min(hi, (q0 + BQ - 1) / BK);
    if (window > 0) lo = max(0, q0 - window) / BK;
  }
}

// Query tiles [lo, hi] that hold a query which may see some key of
// [k0, k0 + BK) (JAX: flash_attention_bwd.py:161-166); empty when the tile
// starts at or past len.
template <bool CAUSAL>
__device__ __forceinline__ void query_tiles(int k0, int n_tiles, int len, int window, int& lo, int& hi) {
  lo = 0;
  hi = k0 < len ? n_tiles - 1 : -1;
  if (CAUSAL) {
    lo = k0 / BQ;
    if (window > 0) hi = min(hi, (k0 + BK - 1 + window) / BQ);
  }
}

// Opt in to more than 48 KB of dynamic shared memory, then launch.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int smem, void* stream, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace legacy
