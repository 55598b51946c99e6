// Shared pieces of the fused stem block kernels (fused_stem_k1.cu, K5a;
// fused_stem_k2.cu, K5b).
//
// float32 route: element loads and stores, the positioned-MixDropout site
// factors and a direct 3x3 convolution over a float tile in shared memory
// on the CUDA cores (conv3x3).
//
// bfloat16 route (the Hopper kernels): the shared-memory geometry both
// kernels use, the site factor of a pair of channels, the swizzle of the
// staging rows that a TMA store writes out and the resident weights.
//
// Layout: the TPU kernels take width-packed tensors [B, H, W/f, f*C]. That
// is the plain NHWC [B, H, W, C] by a reshape, so these kernels index NHWC
// with 3x3 windows and need no widened or patched weights. Weights are the
// original HWIO [3, 3, ci, co], or their wgmma operand (stem_weight_operand
// in ops/fused_stem.py). Every value in a tile is already rounded to the
// kernel's element type; every sum is float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_stem_layout.h"
#include "hopper_common.cuh"

namespace stem {

typedef __nv_bfloat16 bf16;

constexpr int OCB = 16;  // output channels per thread and task: one 16-byte bits load
constexpr int PX = 2;    // pixels per thread and task (lanes of a warp take neighbouring pixels)

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// Pixel stride of a tile in shared memory, in floats: odd, so that lanes
// reading one channel of neighbouring pixels hit distinct banks.
__host__ __device__ __forceinline__ int odd_stride(int c) { return c | 1; }

// OCB consecutive elements (16-element aligned) as float, through the
// read-only path; a warp reads the same address, so one load serves it.
__device__ __forceinline__ void load16(const float* __restrict__ p, float (&v)[OCB]) {
#pragma unroll
  for (int k = 0; k < OCB / 4; ++k) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p) + k);
    v[4 * k] = q.x;
    v[4 * k + 1] = q.y;
    v[4 * k + 2] = q.z;
    v[4 * k + 3] = q.w;
  }
}

__device__ __forceinline__ void store16(float* p, const float (&v)[OCB]) {
#pragma unroll
  for (int k = 0; k < OCB / 4; ++k)
    reinterpret_cast<float4*>(p)[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
}

// The dropout draw of one block (JAX make_drop_ctx): site pos (1..3) is
// active; there use_elem picks elementwise dropout (keep where the u8 bit
// is < t, scaled by inv_e) or channel dropout (the factor fchan[c]).
struct Drop {
  const uint8_t* bits;   // [B, H, W, co] u8, or null without dropout
  const float* fchan;    // [B, co] float32
  int pos, use_elem, t;  // pos and use_elem read from the device by the kernel
  float inv_e;
};

// fac[j] = factor of site `site` at channels oc0..oc0+15 of one pixel;
// bits points at that pixel's channel oc0 (16-byte aligned), fch at
// fchan[b, oc0].
__device__ __forceinline__ void site_factors(float (&fac)[OCB], const Drop& d, int site,
                                             const uint8_t* bits, const float* fch) {
  if (d.pos != site) {
#pragma unroll
    for (int j = 0; j < OCB; ++j) fac[j] = 1.f;
  } else if (d.use_elem) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(bits));
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < OCB; ++j) fac[j] = (int)((w[j >> 2] >> (8 * (j & 3))) & 0xFFu) < d.t ? d.inv_e : 0.f;
  } else {
#pragma unroll
    for (int j = 0; j < OCB; ++j) fac[j] = __ldg(fch + j);
  }
}

// Direct 3x3 convolution of a tile in shared memory, written as tasks of
// one warp: 32 * PX output pixels by OCB output channels. Lane l takes
// pixels base + p * 32 + l, so a warp reads neighbouring pixels (distinct
// banks, pixel stride odd) and one weight vector (a broadcast).
//
// in_s: [rows][in_cols][cinp] floats; output pixel (oy, ox) of an
// out_rows x out_cols grid reads rows oy*sh + 0..2 and columns ox*sw + 0..2
// of it. w: HWIO [3][3][cin][co] in global memory. epi(oy, ox, oc0, acc) is
// called once per valid output pixel and channel group with the float
// sums (no bias).
template <typename TW, typename Epi>
__device__ __forceinline__ void conv3x3(const float* in_s, int in_cols, int cinp, int cin, int out_rows,
                                        int out_cols, int sh, int sw, const TW* __restrict__ w, int co,
                                        Epi&& epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const int npix = out_rows * out_cols;
  const int n_pt = cdiv(npix, 32 * PX), n_ocg = co / OCB;
  for (int task = warp; task < n_pt * n_ocg; task += nwarps) {
    const int ocg = task % n_ocg, pt = task / n_ocg;
    int pix[PX], off[PX];
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      pix[p] = pt * 32 * PX + p * 32 + lane;
      const int q = min(pix[p], npix - 1);
      off[p] = ((q / out_cols) * sh * in_cols + (q % out_cols) * sw) * cinp;
    }
    float acc[PX][OCB];
#pragma unroll
    for (int p = 0; p < PX; ++p)
#pragma unroll
      for (int j = 0; j < OCB; ++j) acc[p][j] = 0.f;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const float* ip = in_s + ((tap / 3) * in_cols + tap % 3) * cinp;
      const TW* wp = w + (size_t)tap * cin * co + ocg * OCB;
#pragma unroll 2
      for (int c = 0; c < cin; ++c) {
        float wv[OCB];
        load16(wp + (size_t)c * co, wv);
#pragma unroll
        for (int p = 0; p < PX; ++p) {
          const float v = ip[off[p] + c];
#pragma unroll
          for (int j = 0; j < OCB; ++j) acc[p][j] = fmaf(v, wv[j], acc[p][j]);
        }
      }
    }
#pragma unroll
    for (int p = 0; p < PX; ++p)
      if (pix[p] < npix) epi(pix[p] / out_cols, pix[p] % out_cols, ocg * OCB, acc[p]);
  }
}


// ---- bfloat16 route: the Hopper kernels
//
// Both kernels are persistent. A consumer warpgroup walks units (one image,
// one column strip, one segment of rows) top to bottom, one image row of 64
// pixels (one wgmma M) at a time; a producer warp of its own keeps TMA
// loads of the rows it will read in flight, in a ring of stages guarded by
// mbarriers. A block is one such pair (160 threads) with its copy of the
// weights; a second consumer warpgroup sharing them ran no faster where it
// fits (blocks 0 and 1) and does not fit block2.
//
// The 3x3 products are implicit GEMMs on wgmma: M = 64 pixels of a row,
// N = co, K = 9 taps x the input channels in 16-deep steps. Their A
// operands are channel-planar rows: a row of pixels is C / 8 planes of
// [pixel][8 channels] (16 bytes a pixel), so the window shifted by dx
// pixels is the same planes at + 16 dx bytes, and a descriptor without
// swizzle reads it as a K-major A (rows 16 bytes apart; the two 8-channel
// halves of a k step one plane apart). B is the weights' operand, resident
// in shared memory for the block's whole walk.

// The layouts, the blocks an SM holds and what a launch takes are in
// fused_stem_layout.h, which the host reads too.

// Byte offset inside a staging row of 2 co bytes a pixel under TMA's
// 32-, 64- or 128-byte swizzle (co 16, 32, 64): the 16-byte chunk index
// XOR the 128-byte line index, so the epilogue's stores of 8 pixel rows
// by a warp hit distinct banks. Staging rows are 1024-byte aligned.
template <int CO>
__device__ __forceinline__ uint32_t stg_swizzle(uint32_t off) {
  constexpr uint32_t mask = CO == 64 ? 7u : CO == 32 ? 3u : 1u;
  return off ^ (((off >> 7) & mask) << 4);
}

inline CUtensorMapSwizzle stg_swizzle_mode(int co) {
  return co == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : co == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
}

// A map of a [B, rows, cols, c] tensor of elem-byte elements (strides of
// c * elem and more bytes: multiples of 16) as (c, cols, rows, B), with box
// (bc, bcols, brows, 1).
inline int make_nhwc_map(CUtensorMap* map, const void* base, CUtensorMapDataType type, int elem, int B, int rows,
                         int cols, int c, int bc, int bcols, int brows, CUtensorMapSwizzle swizzle) {
  const uint64_t dims[4] = {(uint64_t)c, (uint64_t)cols, (uint64_t)rows, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)c * elem, (uint64_t)cols * c * elem, (uint64_t)rows * cols * c * elem};
  const uint32_t box[4] = {(uint32_t)bc, (uint32_t)bcols, (uint32_t)brows, 1};
  return hopper::make_map_nd(map, base, type, 4, dims, strides, box, swizzle);
}

// A consumer's units, in the order every consumer and its producer walk
// them: unit u is (image b, segment seg, strip) with the strip fastest, so
// a wave of consumers holds neighbouring strips of the same rows (their
// halo columns meet in L2). Rows [r0, r1) of `rows`.
struct Unit {
  int b, seg, strip, r0, r1;
};

__device__ __forceinline__ Unit unit_of(int u, int n_strips, int n_seg, int seg_len, int rows) {
  Unit t;
  t.strip = u % n_strips;
  t.seg = (u / n_strips) % n_seg;
  t.b = u / (n_strips * n_seg);
  t.r0 = t.seg * seg_len;
  t.r1 = min(rows, t.r0 + seg_len);
  return t;
}

// The dropout draw's scalars, read from the device once by each block.
struct SiteDrop {
  int pos, use_elem, t;
  float inv_e;
};

// Factors of channels n, n + 1 at dropout site `site`: 1 where the draw is
// elsewhere; else from the u8 bits of the two channels (elementwise) or the
// channel factors fch.
__device__ __forceinline__ float2 pair_factor(const SiteDrop& d, int site, const uint8_t* bits, float2 fch) {
  if (d.pos != site) return make_float2(1.f, 1.f);
  if (!d.use_elem) return fch;
  const uint32_t w = *reinterpret_cast<const uint16_t*>(bits);
  return make_float2((int)(w & 0xFFu) < d.t ? d.inv_e : 0.f, (int)(w >> 8) < d.t ? d.inv_e : 0.f);
}

// Copy `bytes` (a multiple of 16; both ends 16-byte aligned) from device
// to shared memory, by every thread of the block.
__device__ __forceinline__ void copy_to_smem(void* dst, const void* src, int bytes) {
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(dst)[i] = __ldg(reinterpret_cast<const uint4*>(src) + i);
}

__device__ __forceinline__ uint32_t pack_bf2(float v0, float v1) {
  __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  return *reinterpret_cast<uint32_t*>(&h);
}

// A staged row waiting for its TMA store: written by the consumer as it
// makes one row, stored by its thread 0 after the consumer's next barrier.
struct PendingRow {
  int on, buf, col, row, b;
};

}  // namespace stem
