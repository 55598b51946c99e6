// K1c's launch policy (flash_fwd.cu): its consumer warpgroups a block and
// the order of its 1-D grid of blocks.
//
// Plain C++ with no CUDA header, so the same code builds into K1c's library
// (nvcc) and on its own with a host compiler: the CPU tests call the
// extern "C" functions at the end (host builds only) from a host build of
// this file (ops/cuda_build.py host_library) and check that K1c's blocks
// take each (query tile, batch row, head) once and, with flash_band.h's
// band, cover each (query, key) pair of the band once.
#ifndef K1C_PLAN_H
#define K1C_PLAN_H

#ifdef __CUDACC__
#define K1C_HD __device__ __forceinline__
#else
#define K1C_HD inline
#endif

namespace k1c {

// consumer warpgroups of 64 queries in a block, one block an SM
constexpr int CONSUMERS = 3;

// Block `id` of the 1-D grid of n_qt query tiles x B x H: with a window,
// the query tiles of a (batch row, head) side by side; without, the last
// query tiles of every (batch row, head) first, whose bands are the
// longest, so that the short ones fill the last wave.
K1C_HD void block(int id, int n_qt, int B, int H, int window, int& qt, int& b, int& h) {
  const int bh = window > 0 ? id / n_qt : id % (B * H);
  qt = window > 0 ? id % n_qt : n_qt - 1 - id / (B * H);
  h = bh % H;
  b = bh / H;
}

}  // namespace k1c

#ifndef __CUDACC__
// For the host tests: K1c's consumers a block and its block order.
extern "C" int k1c_plan_consumers() { return k1c::CONSUMERS; }

extern "C" void k1c_plan_block(int id, int n_qt, int B, int H, int window, int* qt_b_h) {
  k1c::block(id, n_qt, B, H, window, qt_b_h[0], qt_b_h[1], qt_b_h[2]);
}
#endif  // __CUDACC__

#endif  // K1C_PLAN_H
