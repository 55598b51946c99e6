// Shared pieces of the fused stem block kernels (fused_stem_k1.cu, K5a;
// fused_stem_k2.cu, K5b): element conversions, 16-wide vector loads and
// stores, the positioned-MixDropout site factors and two 3x3 convolutions
// over a tile held in shared memory: direct on the CUDA cores (conv3x3,
// float tiles) and an implicit GEMM on the tensor cores (conv3x3_mma, bf16
// tiles).
//
// Layout: the TPU kernels take width-packed tensors [B, H, W/f, f*C]. That
// is the plain NHWC [B, H, W, C] by a reshape, so these kernels index NHWC
// with 3x3 windows and need no widened or patched weights. Weights are the
// original HWIO [3, 3, ci, co] (or their mma fragments). Every value in a
// tile is already rounded to the kernel's element type; every sum is
// float32 (promote(T, float32) for T in {float, bf16}).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"  // mma16816, ldsm_x4

namespace stem {

typedef __nv_bfloat16 bf16;

constexpr int OCB = 16;  // output channels per thread and task: one 16-byte bits load
constexpr int PX = 2;    // pixels per thread and task (lanes of a warp take neighbouring pixels)
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may take on sm_90

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// Pixel stride of a tile in shared memory, in floats: odd, so that lanes
// reading one channel of neighbouring pixels hit distinct banks.
__host__ __device__ __forceinline__ int odd_stride(int c) { return c | 1; }

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

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

__device__ __forceinline__ float2 bf2_to_f2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

__device__ __forceinline__ void load16(const bf16* __restrict__ p, float (&v)[OCB]) {
#pragma unroll
  for (int k = 0; k < OCB / 8; ++k) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + k);
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = bf2_to_f2(w[i]);
      v[8 * k + 2 * i] = f.x;
      v[8 * k + 2 * i + 1] = f.y;
    }
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

// ---- bf16 tensor-core convolution (mma.sync m16n8k16, float32 sums)
//
// The same 3x3 convolution as an implicit GEMM: out[pixel, oc] = sum over
// (tap, c) of in[pixel + tap offset, c] * w[tap, c, oc]. A warp task is 32
// output pixels (two 16-row tiles) by 8 * NT output channels. A fragments
// come from the bf16 tile in shared memory by ldmatrix, one address per
// pixel row, so any stride and any row of the tile works; the pixel stride
// cs = cin + MMA_PAD keeps ldmatrix's eight rows on distinct banks. B
// fragments come from device memory in the order ldmatrix would give them
// (``mma_weight_fragments`` in ops/fused_stem.py): one 16-byte load per lane
// and pair of 8-channel tiles, shared by every block through L1.
constexpr int MMA_PAD = 8;

__host__ __device__ __forceinline__ int mma_stride(int c) { return c + MMA_PAD; }

// Two consecutive channels (c even): bits as one 16-bit load, factors.
__device__ __forceinline__ void site_factors2(float (&fac)[2], const Drop& d, int site, const uint8_t* bits,
                                              const float* fch) {
  if (d.pos != site) {
    fac[0] = fac[1] = 1.f;
  } else if (d.use_elem) {
    const uint32_t w = *reinterpret_cast<const uint16_t*>(bits);
    fac[0] = (int)(w & 0xFFu) < d.t ? d.inv_e : 0.f;
    fac[1] = (int)(w >> 8) < d.t ? d.inv_e : 0.f;
  } else {
    fac[0] = __ldg(fch);
    fac[1] = __ldg(fch + 1);
  }
}

// in_s: bf16 [rows][in_cols][cs], cs = mma_stride(cin), cin % 16 == 0;
// wf: fragments [9][cin/16][co/16][32 lanes][8] bf16. epi(oy, ox, oc, v0,
// v1) gets channels oc and oc + 1 of one valid output pixel (no bias).
template <int NT, typename Epi>
__device__ __forceinline__ void conv3x3_mma(const bf16* in_s, int in_cols, int cin, int out_rows, int out_cols,
                                            int sh, int sw, const uint4* __restrict__ wf, int co, Epi&& epi) {
  static_assert(NT % 2 == 0, "n tiles come in pairs");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const int cs = mma_stride(cin), npix = out_rows * out_cols;
  const int n_pt = cdiv(npix, 32), n_cg = co / (8 * NT), kc_n = cin / 16, np_n = co / 16;
  for (int task = warp; task < n_pt * n_cg; task += nwarps) {
    const int cg = task % n_cg, pt = task / n_cg;
    int a_off[2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int q = min(pt * 32 + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, npix - 1);
      a_off[mt] = ((q / out_cols) * sh * in_cols + (q % out_cols) * sw) * cs + (lane >> 4) * 8;
    }
    float acc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const bf16* ap = in_s + ((tap / 3) * in_cols + tap % 3) * cs;
      const uint4* bp = wf + ((size_t)tap * kc_n * np_n + cg * (NT / 2)) * 32 + lane;
#pragma unroll 1
      for (int kc = 0; kc < kc_n; ++kc) {
        uint32_t a[2][4];
        flash::ldsm_x4(a[0], ap + a_off[0] + kc * 16);
        flash::ldsm_x4(a[1], ap + a_off[1] + kc * 16);
#pragma unroll
        for (int p = 0; p < NT / 2; ++p) {
          const uint4 q = __ldg(bp + ((size_t)kc * np_n + p) * 32);
          const uint32_t b0[2] = {q.x, q.y}, b1[2] = {q.z, q.w};
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            flash::mma16816(acc[mt][2 * p], a[mt], b0);
            flash::mma16816(acc[mt][2 * p + 1], a[mt], b1);
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int q = pt * 32 + mt * 16 + (lane >> 2) + 8 * hf;
        if (q >= npix) continue;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          epi(q / out_cols, q % out_cols, (cg * NT + nt) * 8 + 2 * (lane & 3), acc[mt][nt][2 * hf],
              acc[mt][nt][2 * hf + 1]);
      }
  }
}

__device__ __forceinline__ void store_bf2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

}  // namespace stem
