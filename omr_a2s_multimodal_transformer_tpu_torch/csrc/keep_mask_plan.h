// The walk of K4 (keep_mask.cu): which rows and keys of the keep-mask
// out[B*H*Lq_p rows, Lk_p keys] each lane of each warp writes.
//
// A unit is (strip, row): the STRIP consecutive keys of one row that a warp
// writes with one 16-byte store a lane. Units are numbered strip-major
// (strip * rows + row), and the n warps of the persistent grid take equal
// runs of them (unit_begin), so a warp walks consecutive rows of one strip
// (rarely two) with its column terms in registers, and its (b, h, q)
// advance by a counter rather than a division a row. No grid dimension
// carries a row or a (batch, head) index, so every size the JAX probe takes
// launches.
//
// Plain C++ with no CUDA header, so the same code builds into K4's library
// (nvcc) and on its own with a host compiler: the CPU tests call
// keep_mask_walk_counts (host builds only) from a host build of this file
// (ops/cuda_build.py host_library) and check that the walk writes every
// (row, 16-key group) once with the right (b, h, q).
#ifndef KEEP_MASK_PLAN_H
#define KEEP_MASK_PLAN_H

#include <stdint.h>

#ifdef __CUDACC__
#define KM_HD __host__ __device__ __forceinline__
#else
#define KM_HD inline
#endif

namespace km {

constexpr int KEYS = 16;          // keys a lane writes to a row: one 16-byte store
constexpr int STRIP = 32 * KEYS;  // keys a warp writes to a row: a unit
constexpr int THREADS = 256;      // a block
constexpr int BLOCKS_PER_SM = 4;  // the blocks an SM holds (keep_mask_kernel's __launch_bounds__)

struct Geometry {
  int B, H, Lq, Lk;  // Lq, Lk: the padded lengths Lq_p, Lk_p
  int mbq;           // the mask q-block: Lq is a multiple of it
  int64_t workers;   // warps of the grid
};

KM_HD int64_t n_rows(const Geometry& g) { return (int64_t)g.B * g.H * g.Lq; }

KM_HD int64_t n_units(const Geometry& g) { return n_rows(g) * ((g.Lk + STRIP - 1) / STRIP); }

// The first unit of worker w of n over `units`: runs of units / n, one more
// for the first units % n workers.
KM_HD int64_t unit_begin(int64_t units, int64_t n, int64_t w) {
  const int64_t extra = units % n;
  return w * (units / n) + (w < extra ? w : extra);
}

// Worker w's walk for lane `lane`. The visitor v takes
//   v.strip(k0)             the lane's first key of a new strip (its 16 keys k0..k0+15 < Lk),
//   v.block(b, h, qi, qm)   the (batch, head, mask q-block) of the next row and its row qm in the q-block,
//   v.row(r)                row r = (b * H + h) * Lq + qi * mbq + qm, after which qm counts up by one;
// block() comes before the first row of a strip and before each row whose
// qm is 0. A lane whose keys lie past Lk in a strip skips that strip.
#ifdef __CUDACC__
#pragma nv_exec_check_disable  // the kernel's visitor is device code, the host tests' host code
#endif
template <typename Visitor>
KM_HD void walk(const Geometry& g, int64_t w, int lane, Visitor& v) {
  const int64_t rows = n_rows(g), units = n_units(g);
  int64_t u = unit_begin(units, g.workers, w);
  const int64_t end = unit_begin(units, g.workers, w + 1);
  while (u < end) {
    const int strip = (int)(u / rows);
    int64_t r = u % rows;
    const int64_t stop = rows - r < end - u ? rows : r + (end - u);  // the run's rows in this strip
    u += stop - r;
    const int k0 = strip * STRIP + lane * KEYS;
    if (k0 >= g.Lk) continue;
    const int bh = (int)(r / g.Lq), q = (int)(r % g.Lq);
    int b = bh / g.H, h = bh % g.H, qi = q / g.mbq, qm = q % g.mbq;
    v.strip(k0);
    v.block(b, h, qi, qm);
    for (; r < stop; ++r) {
      v.row(r);
      if (++qm == g.mbq) {  // the next row starts a mask q-block (and perhaps a head)
        qm = 0;
        if (++qi * g.mbq == g.Lq) {
          qi = 0;
          if (++h == g.H) {
            h = 0;
            ++b;
          }
        }
        if (r + 1 < stop) v.block(b, h, qi, 0);
      }
    }
  }
}

}  // namespace km

#ifndef __CUDACC__
// For the host tests: the keys a lane writes to a row (the wrapper's
// KEEP_MASK_KEYS).
extern "C" int keep_mask_keys() { return km::KEYS; }

// For the host tests: run every lane of every one of `workers` warps over
// the mask [B*H*Lq, Lk] and count the writes to each (row, 16-key group) in
// counts (rows x Lk / 16, saturating at 255). Returns the number of rows
// visited with another (b, h, q) than their index gives (0 for a right walk).
extern "C" int64_t keep_mask_walk_counts(int B, int H, int Lq, int Lk, int mbq, int64_t workers, uint8_t* counts) {
  struct Counter {
    const km::Geometry& g;
    uint8_t* counts;
    int64_t wrong = 0;
    int k0 = 0, b = 0, h = 0, q = 0;
    void strip(int k) { k0 = k; }
    void block(int b_, int h_, int qi, int qm) {
      b = b_;
      h = h_;
      q = qi * g.mbq + qm;
    }
    void row(int64_t r) {
      if (r != ((int64_t)b * g.H + h) * g.Lq + q) ++wrong;
      ++q;
      uint8_t& c = counts[r * (g.Lk / km::KEYS) + k0 / km::KEYS];
      if (c < 255) ++c;
    }
  };
  const km::Geometry g{B, H, Lq, Lk, mbq, workers};
  Counter v{g, counts};
  for (int64_t w = 0; w < workers; ++w) {
    for (int lane = 0; lane < 32; ++lane) km::walk(g, w, lane, v);
  }
  return v.wrong;
}
#endif  // __CUDACC__

#endif  // KEEP_MASK_PLAN_H
