// Geometry of the bf16 fused stem kernels (fused_stem_k1.cu, K5a;
// fused_stem_k2.cu, K5b) that the host needs as well as the kernels: their
// shared-memory layouts, the blocks an SM holds, the widths and the rows a
// stage they take, and K5b's map of the site-3 dropout bits.
//
// Plain C++ with no CUDA header, so the same code builds into the kernels'
// libraries (nvcc, through fused_stem_common.cuh) and on its own with a
// host compiler. The wrappers' launch plans (ops/fused_stem.py k1_plan,
// k2_plan) and the launchers call the extern "C" functions at the end; the
// CPU tests call them from a host build of this file
// (ops/cuda_build.py host_library).
#ifndef FUSED_STEM_LAYOUT_H
#define FUSED_STEM_LAYOUT_H

#include <stdint.h>

#ifdef __CUDACC__
#define STEM_HD __host__ __device__ __forceinline__
#else
#define STEM_HD inline
#endif

namespace stem {

constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may take on sm_90
constexpr int SMEM_SM = 233472;   // shared memory of an SM on sm_90; each resident block also takes 1 KB of it
constexpr int CONS_THREADS = 128;  // a consumer warpgroup
constexpr int PROD_THREADS = 32;   // its producer warp

STEM_HD int align_up(int n, int a) { return (n + a - 1) / a * a; }

// bytes of the wgmma B operand of a 3x3 convolution: K / 16 steps of
// [2 halves][co][8] bf16 (K = 9 cin, or 16 for cin == 1)
STEM_HD int weight_bytes(int cin, int co) { return (cin == 1 ? 1 : 9 * cin / 16) * 32 * co; }

// blocks an SM holds by registers: the __launch_bounds__ of both kernels
STEM_HD constexpr int min_blocks(int co) { return co == 16 ? 4 : co == 32 ? 2 : 1; }

// the channel counts whose products the kernels instantiate (N of wgmma)
STEM_HD bool width_taken(int c) { return c == 16 || c == 32 || c == 64; }

// blocks an SM holds: by registers, by shared memory (smem bytes and 1 KB
// each) and by threads
STEM_HD int blocks_per_sm(int co, int smem) {
  int n = min_blocks(co);
  if (SMEM_SM / (smem + 1024) < n) n = SMEM_SM / (smem + 1024);
  if (2048 / (CONS_THREADS + PROD_THREADS) < n) n = 2048 / (CONS_THREADS + PROD_THREADS);
  return n < 1 ? 1 : n;
}

}  // namespace stem

namespace k5a {

constexpr int STRIP = 62;    // y2 columns a strip produces
constexpr int XW = 66;       // x columns a strip reads at ci % 16 == 0: the 64 h1 columns and their halo
constexpr int XW1 = 80;      // x columns a strip reads at ci == 1 (2-byte pixels), from the 8-column boundary at or
                             // below its first: a box's innermost start must be 16-byte aligned (else the load
                             // faults with an illegal instruction)
constexpr int HPW = 66;      // h1 plane width: 64 computed columns + 2 that feed only discarded outputs
constexpr int NST = 4;       // x ring stages
constexpr int NBS = 3;       // bits ring stages, one row each
constexpr int MIN_ROWS = 1;  // x rows a stage holds
constexpr int MAX_ROWS = 8;

// Shared memory of a block: the weights' operands, then the consumer's
// region: two staging rows (1024-byte aligned, for the swizzled TMA
// store), 3 h1 rows (co / 8 planes of HPW x 16 bytes), the statistics'
// scratch (4 warps x 2 x co floats), at ci == 1 conv1's A operand (64
// pixels x 16 taps, two 8-tap planes), the mbarriers, then what the launch
// sizes: the x ring (NST stages of ci / 8 planes of R x XW x 16 bytes, or
// R x XW1 bf16 at ci == 1) and the bits ring (NBS rows of 64 x co bytes;
// only with dropout). Every offset before the x ring is a constant of the
// kernel's instance.
struct Layout {
  int w2, wbytes, per, stg_row, x, x_plane, x_stage, bits, h1, h1_slot, red, a1, bar, total;
};

STEM_HD Layout layout(int ci, int co, int rows, int has_bits) {
  using stem::align_up;
  Layout L;
  L.w2 = align_up(stem::weight_bytes(ci, co), 128);
  L.wbytes = align_up(L.w2 + stem::weight_bytes(co, co), 1024);
  L.stg_row = align_up(STRIP * co * 2, 1024);
  L.h1 = 2 * L.stg_row;
  L.h1_slot = co / 8 * HPW * 16;
  L.red = L.h1 + 3 * L.h1_slot;
  L.a1 = align_up(L.red + 4 * 2 * co * 4, 128);  // ci == 1: conv1's A, 64 pixels x 16 taps
  L.bar = L.a1 + (ci == 1 ? 64 * 16 * 2 : 0);
  L.x = align_up(L.bar + 8 * 2 * (NST + NBS), 128);
  L.x_plane = ci == 1 ? align_up(rows * XW1 * 2, 128) : align_up(rows * XW * 16, 128);
  L.x_stage = ci == 1 ? L.x_plane : ci / 8 * L.x_plane;
  L.bits = L.x + NST * L.x_stage;
  L.per = align_up(L.bits + (has_bits ? NBS * 64 * co : 0), 1024);
  L.total = 1024 + L.wbytes + L.per;
  return L;
}

}  // namespace k5a

namespace k5b {

constexpr int STRIP = 64;     // output columns a strip produces
constexpr int NST = 2;        // y2 ring stages
constexpr int NBS = 3;        // bits ring stages, one output row each (two are held while the next loads)
constexpr int MIN_ROWS = 2;   // y2 rows a stage holds: the first step's 3 rows fit the 2 stages
constexpr int MAX_ROWS = 16;

// y2 columns a strip reads, and the pixels of a plane of a normalized row
STEM_HD int in_cols(int sw) { return 63 * sw + 3; }
STEM_HD int plane_px(int sw) { return sw == 2 ? 65 : 67; }

// Shared memory of a block: the weights' operand, then the consumer's
// region: two staging rows (1024-byte aligned), 3 normalized rows (sw
// column parities x co / 8 planes of plane_px x 16 bytes; odd plane widths
// keep the normalize's stores off each other's banks), the mbarriers, then
// what the launch sizes: the y2 ring (NST stages of rows x in_cols x co
// bf16, as TMA writes them) and the bits ring (NBS rows of 64 x co bytes;
// only with dropout). Every offset before the y2 ring is a constant of the
// kernel's instance.
struct Layout {
  int wbytes, per, stg_row, raw, raw_stage, xh, xh_plane, xh_q, xh_slot, bits, bar, total;
};

STEM_HD Layout layout(int co, int sw, int rows, int has_bits) {
  using stem::align_up;
  Layout L;
  L.wbytes = align_up(stem::weight_bytes(co, co), 1024);
  L.stg_row = align_up(STRIP * co * 2, 1024);
  L.xh = 2 * L.stg_row;
  L.xh_plane = plane_px(sw) * 16;
  L.xh_q = co / 8 * L.xh_plane;
  L.xh_slot = sw * L.xh_q;
  L.bar = L.xh + 3 * L.xh_slot;
  L.raw = align_up(L.bar + 8 * 2 * (NST + NBS), 128);
  L.raw_stage = align_up(rows * in_cols(sw) * co * 2, 128);
  L.bits = L.raw + NST * L.raw_stage;
  L.per = align_up(L.bits + (has_bits ? NBS * 64 * co : 0), 1024);
  L.total = 1024 + L.wbytes + L.per;
  return L;
}

}  // namespace k5b

// What a launch of a bf16 kernel takes. out[0]: the dynamic shared memory of
// a block in bytes (the layout's total); out[1]: the blocks an SM holds;
// out[2]: the strip (K5a: y2 columns, K5b: output columns); out[3], out[4]:
// the least and the most rows a stage holds (K5a: x rows, K5b: y2 rows).
// Returns STEM_FIT_OK, or what the kernel does not take.
enum { STEM_FIT_OK = 0, STEM_FIT_WIDTHS = 1, STEM_FIT_ROWS = 2, STEM_FIT_SMEM = 3 };

static inline int stem_fit(int co, int smem, int strip, int min_rows, int max_rows, int rows, int* out) {
  out[0] = smem;
  out[1] = stem::blocks_per_sm(co, smem);
  out[2] = strip;
  out[3] = min_rows;
  out[4] = max_rows;
  if (rows < min_rows || rows > max_rows) return STEM_FIT_ROWS;
  return smem > stem::SMEM_MAX ? STEM_FIT_SMEM : STEM_FIT_OK;
}

// K5a: x [.., ci] -> y2 [.., co], `rows` x rows a stage; ci 1, 16, 32 or 64,
// co 16, 32 or 64.
extern "C" int fused_stem_k1_fit(int ci, int co, int rows, int has_drop, int* out) {
  if (!stem::width_taken(co) || (ci != 1 && !stem::width_taken(ci))) return STEM_FIT_WIDTHS;
  return stem_fit(co, k5a::layout(ci, co, rows, has_drop).total, k5a::STRIP, k5a::MIN_ROWS, k5a::MAX_ROWS, rows,
                  out);
}

// K5b: y2 [.., co] -> out at stride (sh, sw), f_out packed slots out of
// f_in, `rows` y2 rows a stage; co 16, 32 or 64, sh and sw 1 or 2, f_out
// dividing 64.
extern "C" int fused_stem_k2_fit(int co, int sh, int sw, int f_out, int rows, int has_drop, int* out) {
  if (!stem::width_taken(co) || (sh != 1 && sh != 2) || (sw != 1 && sw != 2) || f_out < 1 || 64 % f_out)
    return STEM_FIT_WIDTHS;
  return stem_fit(co, k5b::layout(co, sw, rows, has_drop).total, k5b::STRIP, k5b::MIN_ROWS, k5b::MAX_ROWS, rows,
                  out);
}

// K5b's map of the packed draw bits [B, H, Wp, f_in * co] (u8) at site 3:
// dims (co, f_in, Wp, H, B), innermost first, and the byte strides of the
// outer four; a box (co, f_out, 64 / f_out, 1, 1) at (0, 0, p0, oy, b)
// takes the f_out slots of the corner bits[:, :H3, :, :f_out * co] that the
// 64 output columns from p0 * f_out read.
extern "C" void fused_stem_site3_map(int B, int H, int Wp, int f_in, int f_out, int co, uint64_t* dims,
                                     uint64_t* strides, uint32_t* box) {
  const uint64_t d[5] = {(uint64_t)co, (uint64_t)f_in, (uint64_t)Wp, (uint64_t)H, (uint64_t)B};
  const uint32_t bx[5] = {(uint32_t)co, (uint32_t)f_out, (uint32_t)(k5b::STRIP / f_out), 1, 1};
  uint64_t s = 1;
  for (int i = 0; i < 5; ++i) {
    if (i > 0) strides[i - 1] = s;
    s *= d[i];
    dims[i] = d[i];
    box[i] = bx[i];
  }
}

#endif  // FUSED_STEM_LAYOUT_H
