// K5b: pass B of the fused stem block.
//
// Replaces omr_a2s_multimodal_transformer_tpu/ops/fused_stem.py _k2_kernel
// (:412) and _k2_compute (:462), pallas_call :581. For one ConvBlock, with
// mean and inv from K5a's statistics:
//
//   xh  = round_T(where(in image, (y2 - mean[c]) * inv[c], 0))   (float32)
//   out = round_T(relu(conv3(xh, stride (sh, sw)) + b3) * site-3 factor)
//
// over the unpacked NHWC image: the normalize comes before conv3's zero
// padding (0 outside the image, not -mean * inv); round_T rounds to the
// element type T (float32 or bf16). Site 3 reads the corner
// bits[:, :H3, :Wp, :f_out * co] of the packed draw: unpacked output column
// ox takes the bit of input column (ox / f_out) * f_in + ox % f_out.
//
// One block computes a tho x two tile of the output of one image from the
// y2 rows and columns it reads (with a 1-pixel halo), normalized into
// shared memory on the way in.
//
// bfloat16 runs conv3 on the tensor cores (conv3x3_mma), float32 on the
// CUDA cores (conv3x3).
//
// What bounds it on the H100: the bytes of y2, the bits and out (0.15-0.30
// ms per stem block at b8 and 3.35 TB/s); 59 GFLOP of products per block.
#include "fused_stem_common.cuh"

using namespace stem;

constexpr int K2_THREADS = 128;

template <bool DROP>
__global__ void __launch_bounds__(K2_THREADS)
fused_stem_k2_kernel(const float* __restrict__ y2, const float* __restrict__ mi, const uint8_t* __restrict__ bits,
                     const float* __restrict__ fchan, const int* __restrict__ scal, const float* __restrict__ w3,
                     const float* __restrict__ b3, float* __restrict__ out, int H, int W, int co, int sh, int sw,
                     int f_in, int f_out, int tho, int two, int t_keep, float inv_e) {
  extern __shared__ float smem[];
  const int H3 = cdiv(H, sh), W3 = W / sw;
  const int tiles_w = cdiv(W3, two);
  const int tile = blockIdx.x, b = blockIdx.y;
  const int oy0 = (tile / tiles_w) * tho, ox0 = (tile % tiles_w) * two;
  const int ir = (tho - 1) * sh + 3, ic = (two - 1) * sw + 3, cop = odd_stride(co);
  float* in_s = smem;

  Drop d{nullptr, nullptr, 0, 0, t_keep, inv_e};
  if constexpr (DROP) {
    d.bits = bits + (size_t)b * H * W * co;
    d.fchan = fchan + (size_t)b * co;
    d.pos = scal[0];
    d.use_elem = scal[1];
  }

  // normalized y2 rows [oy0*sh - 1, +ir), columns [ox0*sw - 1, +ic)
  const float* yb = y2 + (size_t)b * H * W * co;
  const float* mean = mi + (size_t)b * 2 * co;
  const float* inv = mean + co;
  const int y0 = oy0 * sh - 1, x0 = ox0 * sw - 1;
  for (int i = threadIdx.x; i < ir * ic * co; i += blockDim.x) {
    const int r = i / (ic * co), rem = i % (ic * co), c = rem / co, ch = rem % co;
    const int gy = y0 + r, gx = x0 + c;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = (yb[((size_t)gy * W + gx) * co + ch] - __ldg(mean + ch)) * __ldg(inv + ch);
    in_s[(r * ic + c) * cop + ch] = v;
  }
  __syncthreads();

  float* ob = out + (size_t)b * H3 * W3 * co;
  conv3x3(in_s, ic, cop, co, tho, two, sh, sw, w3, co, [&](int ly, int lx, int oc0, const float(&acc)[OCB]) {
    const int oy = oy0 + ly, ox = ox0 + lx;
    if (oy >= H3 || ox >= W3) return;
    float fac[OCB], v[OCB];
    if constexpr (DROP) {
      const int bx = (ox / f_out) * f_in + ox % f_out;
      site_factors(fac, d, 3, d.bits + ((size_t)oy * W + bx) * co + oc0, d.fchan + oc0);
    }
#pragma unroll
    for (int j = 0; j < OCB; ++j) {
      v[j] = fmaxf(acc[j] + b3[oc0 + j], 0.f);
      if constexpr (DROP) v[j] *= fac[j];
    }
    store16(ob + ((size_t)oy * W3 + ox) * co + oc0, v);
  });
}

// The bf16 kernel: the same function as fused_stem_k2_kernel with the
// normalized tile rounded to bf16, conv3 on the tensor cores over that tile
// (8 channels a load and store).
template <bool DROP, int NT>
__global__ void __launch_bounds__(K2_THREADS)
fused_stem_k2_mma_kernel(const bf16* __restrict__ y2, const float* __restrict__ mi, const uint8_t* __restrict__ bits,
                         const float* __restrict__ fchan, const int* __restrict__ scal, const uint4* __restrict__ w3f,
                         const bf16* __restrict__ b3, bf16* __restrict__ out, int H, int W, int co, int sh, int sw,
                         int f_in, int f_out, int tho, int two, int t_keep, float inv_e) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H3 = cdiv(H, sh), W3 = W / sw;
  const int tiles_w = cdiv(W3, two);
  const int tile = blockIdx.x, b = blockIdx.y;
  const int oy0 = (tile / tiles_w) * tho, ox0 = (tile % tiles_w) * two;
  const int ir = (tho - 1) * sh + 3, ic = (two - 1) * sw + 3, cs = mma_stride(co), nv = co / 8;
  bf16* in_s = reinterpret_cast<bf16*>(smem_raw);

  Drop d{nullptr, nullptr, 0, 0, t_keep, inv_e};
  if constexpr (DROP) {
    d.bits = bits + (size_t)b * H * W * co;
    d.fchan = fchan + (size_t)b * co;
    d.pos = scal[0];
    d.use_elem = scal[1];
  }

  // normalized y2 rows [oy0*sh - 1, +ir), columns [ox0*sw - 1, +ic), 8 channels a step
  const bf16* yb = y2 + (size_t)b * H * W * co;
  const float* mean = mi + (size_t)b * 2 * co;
  const float* inv = mean + co;
  const int y0 = oy0 * sh - 1, x0 = ox0 * sw - 1;
  for (int i = threadIdx.x; i < ir * ic * nv; i += blockDim.x) {
    const int r = i / (ic * nv), rem = i % (ic * nv), c = rem / nv, v = rem % nv;
    const int gy = y0 + r, gx = x0 + c;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(yb + ((size_t)gy * W + gx) * co) + v);
      const uint32_t in[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int ch = v * 8 + 2 * k;
        const float2 f = bf2_to_f2(in[k]);
        __nv_bfloat162 h = __floats2bfloat162_rn((f.x - __ldg(mean + ch)) * __ldg(inv + ch),
                                                 (f.y - __ldg(mean + ch + 1)) * __ldg(inv + ch + 1));
        w[k] = *reinterpret_cast<uint32_t*>(&h);
      }
    }
    *reinterpret_cast<uint4*>(in_s + (r * ic + c) * cs + v * 8) = make_uint4(w[0], w[1], w[2], w[3]);
  }
  __syncthreads();

  bf16* ob = out + (size_t)b * H3 * W3 * co;
  conv3x3_mma<NT>(in_s, ic, co, tho, two, sh, sw, w3f, co, [&](int ly, int lx, int oc, float v0, float v1) {
    const int oy = oy0 + ly, ox = ox0 + lx;
    if (oy >= H3 || ox >= W3) return;
    v0 = fmaxf(v0 + to_f(b3[oc]), 0.f);
    v1 = fmaxf(v1 + to_f(b3[oc + 1]), 0.f);
    if constexpr (DROP) {
      float fac[2];
      const int bx = (ox / f_out) * f_in + ox % f_out;
      site_factors2(fac, d, 3, d.bits + ((size_t)oy * W + bx) * co + oc, d.fchan + oc);
      v0 *= fac[0];
      v1 *= fac[1];
    }
    store_bf2(ob + ((size_t)oy * W3 + ox) * co + oc, v0, v1);
  });
}

static int k2_mma_smem_bytes(int co, int sh, int sw, int tho, int two) {
  return ((tho - 1) * sh + 3) * ((two - 1) * sw + 3) * mma_stride(co) * 2;
}

static int k2_smem_bytes(int co, int sh, int sw, int tho, int two) {
  return ((tho - 1) * sh + 3) * ((two - 1) * sw + 3) * odd_stride(co) * 4;
}

template <bool DROP>
static int launch(const void* y2, const void* mi, const void* bits, const void* fchan, const void* scal,
                  const void* w3, const void* b3, void* out, int B, int H, int W, int co, int sh, int sw, int f_in,
                  int f_out, int tho, int two, int t_keep, float inv_e, cudaStream_t stream) {
  const int smem = k2_smem_bytes(co, sh, sw, tho, two);
  auto kern = fused_stem_k2_kernel<DROP>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = cdiv(cdiv(H, sh), tho) * cdiv(W / sw, two);
  kern<<<dim3(n_tiles, B), K2_THREADS, smem, stream>>>(
      (const float*)y2, (const float*)mi, (const uint8_t*)bits, (const float*)fchan, (const int*)scal, (const float*)w3,
      (const float*)b3, (float*)out, H, W, co, sh, sw, f_in, f_out, tho, two, t_keep, inv_e);
  return (int)cudaGetLastError();
}

template <bool DROP, int NT>
static int launch_mma(const void* y2, const void* mi, const void* bits, const void* fchan, const void* scal,
                      const void* w3f, const void* b3, void* out, int B, int H, int W, int co, int sh, int sw,
                      int f_in, int f_out, int tho, int two, int t_keep, float inv_e, cudaStream_t stream) {
  const int smem = k2_mma_smem_bytes(co, sh, sw, tho, two);
  auto kern = fused_stem_k2_mma_kernel<DROP, NT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = cdiv(cdiv(H, sh), tho) * cdiv(W / sw, two);
  kern<<<dim3(n_tiles, B), K2_THREADS, smem, stream>>>(
      (const bf16*)y2, (const float*)mi, (const uint8_t*)bits, (const float*)fchan, (const int*)scal,
      (const uint4*)w3f, (const bf16*)b3, (bf16*)out, H, W, co, sh, sw, f_in, f_out, tho, two, t_keep, inv_e);
  return (int)cudaGetLastError();
}

// dtype: 0 float32 (CUDA cores), 1 bfloat16 (tensor cores; w3f holds the
// weights in mma fragment order). co a multiple of 16; y2 [B, H, W, co],
// mi float32 [B, 2, co] (mean, inv), bits [B, H, W, co] (null without
// dropout), fchan [B, co], scal int32 {pos, use_elem} on the device, out
// [B, ceil(H/sh), W/sw, co]; f_out * sw == f_in.
extern "C" int fused_stem_k2_launch(const void* y2, const void* mi, const void* bits, const void* fchan,
                                    const void* scal, const void* w3, const void* w3f, const void* b3, void* out,
                                    int dtype, int has_drop, int B, int H, int W, int co, int sh, int sw, int f_in,
                                    int f_out, int tho, int two, int t_keep, float inv_e, void* stream) {
  const int smem = dtype == 0 ? k2_smem_bytes(co, sh, sw, tho, two) : k2_mma_smem_bytes(co, sh, sw, tho, two);
  if (co % OCB || W % sw || f_out * sw != f_in || smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define K2_ARGS y2, mi, bits, fchan, scal, w3, b3, out, B, H, W, co, sh, sw, f_in, f_out, tho, two, t_keep, inv_e, s
#define K2_MMA_ARGS y2, mi, bits, fchan, scal, w3f, b3, out, B, H, W, co, sh, sw, f_in, f_out, tho, two, t_keep, inv_e, s
  if (dtype == 0) return has_drop ? launch<true>(K2_ARGS) : launch<false>(K2_ARGS);
  if (dtype == 1 && co % 32 == 0)
    return has_drop ? launch_mma<true, 4>(K2_MMA_ARGS) : launch_mma<false, 4>(K2_MMA_ARGS);
  if (dtype == 1) return has_drop ? launch_mma<true, 2>(K2_MMA_ARGS) : launch_mma<false, 2>(K2_MMA_ARGS);
#undef K2_ARGS
#undef K2_MMA_ARGS
  return (int)cudaErrorInvalidValue;
}
