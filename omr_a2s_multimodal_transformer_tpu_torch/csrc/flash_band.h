// The causal band of the head-packed and per-head flash kernels: which
// 64-key tiles a block or a consumer warpgroup of 64 queries walks, and the
// key test of each score (shared by every kernel through flash_common.cuh).
//
// Plain C++ with no CUDA header, so the same code builds into the kernels'
// libraries (nvcc: device functions) and on its own with a host compiler:
// the CPU tests call the extern "C" functions at the end (host builds only)
// from a host build of this file (ops/cuda_build.py host_library) and check
// that a causal forward's blocks and consumers (K1c's, with k1c_plan.h)
// cover each (query, key) pair of the band once. (Marked __host__ __device__ for nvcc, with their min and max
// written as conditionals, these functions made ptxas branch on each
// score's band test in K3a: 14-18% slower at the paper's self-attention
// shape on the H100.)
#ifndef FLASH_BAND_H
#define FLASH_BAND_H

#include <stdint.h>

#ifdef __CUDACC__
#define BAND_HD __device__ __forceinline__
#else
#include <algorithm>
#define BAND_HD inline
using std::max;
using std::min;
#endif

namespace flash {

constexpr int BQ = 64;  // queries per tile
constexpr int BK = 64;  // keys per tile

// The band half of the key test (JAX _row_mask, ops/flash_packed.py:63-73):
// for a causal call, query q sees key k when k <= q and (window > 0 only)
// k >= q - window.
template <bool CAUSAL>
BAND_HD bool in_band(int q, int k, int window) {
  return !CAUSAL || (k <= q && (window <= 0 || k >= q - window));
}

// Key tiles [lo, hi] that hold a key some query of [q0, q0 + rows) may see
// (empty when lo > hi). The skip is by 64-key tile; the key test above
// still masks each score, so the result equals the JAX block skip's.
template <bool CAUSAL>
BAND_HD void key_tiles(int q0, int n_tiles, int window, int& lo, int& hi, int rows = BQ) {
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
BAND_HD void query_tiles(int k0, int n_tiles, int window, int& lo, int& hi, int keys = BK) {
  lo = 0;
  hi = n_tiles - 1;
  if (CAUSAL) {
    lo = k0 / BQ;
    if (window > 0) hi = min(hi, (k0 + keys - 1 + window) / BQ);
  }
}

// Whether some query of [q0, q0 + 64) may see some key of the 64-key tile
// from k0, in a causal call: a consumer warpgroup of the forward runs no
// product on a tile of its block's band that fails this.
BAND_HD bool tile_meets_band(int q0, int k0, int window) {
  return k0 <= q0 + (BQ - 1) && (window <= 0 || k0 + (BK - 1) >= q0 - window);
}

}  // namespace flash

#ifndef __CUDACC__
// For the host tests: a causal block's key tiles, a consumer's tile test
// and the score test, as the kernels compute them.
extern "C" void flash_band_key_tiles(int q0, int n_tiles, int window, int rows, int* lo_hi) {
  flash::key_tiles<true>(q0, n_tiles, window, lo_hi[0], lo_hi[1], rows);
}

extern "C" int flash_band_tile_meets_band(int q0, int k0, int window) { return flash::tile_meets_band(q0, k0, window); }

extern "C" int flash_band_in_band(int q, int k, int window) { return flash::in_band<true>(q, k, window); }
#endif  // __CUDACC__

#endif  // FLASH_BAND_H
