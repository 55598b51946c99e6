// K5a: pass A of the fused stem block.
//
// Replaces omr_a2s_multimodal_transformer_tpu/ops/fused_stem.py _k1_kernel
// (:288) and _k1_compute (:340), pallas_call :521. For one ConvBlock:
//
//   h1 = round_T(where(in image, relu(conv1(x) + b1) * site-1 factor, 0))
//   y2 = round_T(relu(conv2(h1) + b2) * site-2 factor)
//   stats[b, 0, c] = sum of y2[b, ..., c], stats[b, 1, c] = sum of y2^2
//
// over the unpacked NHWC image (module note in fused_stem_common.cuh), with
// zero padding of x before conv1 and of h1 before conv2, and statistics of
// the stored (rounded) y2; round_T rounds to the element type T (float32
// or bf16), and sums are float32.
//
// One block computes a th x tw tile of y2 for one image: it loads x with a
// 2-pixel halo, computes h1 on the tile plus a 1-pixel halo into shared
// memory (the halo is recomputed by the neighbouring tiles: h1 never goes
// to device memory), then y2, which it stores and sums per channel into its
// own slot of `partial`. A second kernel adds the slots of each image in a
// fixed order, so the statistics are the same bits on every run (no float
// atomics). The TPU kernel walks the tiles of an image in sequence and
// carries halos and sums in VMEM; here the tiles run in parallel.
//
// Two routes. bfloat16 (the train step's type): conv2, and conv1 where
// ci % 16 == 0, run on the tensor cores (mma.sync m16n8k16, implicit GEMM
// over the bf16 tile, fused_stem_common.cuh conv3x3_mma); conv1 of the
// first stem block (ci = 1) stays on the CUDA cores. float32: both
// convolutions on the CUDA cores (conv3x3), a reference of the same
// function at full precision.
//
// What bounds it on the H100: 62-354 GFLOP of 3x3 products per stem block
// at b8 (0.19-0.37 ms of bytes at 3.35 TB/s, block2 0.36 ms of bf16 tensor
// operations). Above the bound it pays for the conv1 halo that each tile
// recomputes, for mma.sync rather than wgmma, and for bf16 tiles staged
// through shared memory without an asynchronous pipeline.
#include "fused_stem_common.cuh"

using namespace stem;

constexpr int K1_THREADS = 256;
constexpr int STATS_THREADS = 512;

template <bool DROP>
__global__ void __launch_bounds__(K1_THREADS)
fused_stem_k1_kernel(const float* __restrict__ x, const uint8_t* __restrict__ bits, const float* __restrict__ fchan,
                     const int* __restrict__ scal, const float* __restrict__ w1, const float* __restrict__ b1,
                     const float* __restrict__ w2, const float* __restrict__ b2, float* __restrict__ y2,
                     float* __restrict__ partial, int H, int W, int ci, int co, int th, int tw, int t_keep,
                     float inv_e) {
  extern __shared__ float smem[];
  const int tiles_w = cdiv(W, tw), n_tiles = cdiv(H, th) * tiles_w;
  const int tile = blockIdx.x, b = blockIdx.y;
  const int r0 = (tile / tiles_w) * th, c0 = (tile % tiles_w) * tw;
  const int cip = odd_stride(ci), cop = odd_stride(co);
  const int xc = tw + 4, hr = th + 2, hc = tw + 2;
  const int x_floats = (th + 4) * xc * cip;
  float* x_s = smem;  // x tile, later the y2 tile (th * tw * co)
  float* h1_s = smem + max(x_floats, th * tw * co);
  float* red_s = h1_s + hr * hc * cop;

  Drop d{nullptr, nullptr, 0, 0, t_keep, inv_e};
  if constexpr (DROP) {
    d.bits = bits + (size_t)b * H * W * co;
    d.fchan = fchan + (size_t)b * co;
    d.pos = scal[0];
    d.use_elem = scal[1];
  }

  // x rows [r0-2, r0+th+2), columns [c0-2, c0+tw+2), zero outside the image
  const float* xb = x + (size_t)b * H * W * ci;
  for (int i = threadIdx.x; i < (th + 4) * xc * ci; i += blockDim.x) {
    const int r = i / (xc * ci), rem = i % (xc * ci), c = rem / ci, ch = rem % ci;
    const int gy = r0 - 2 + r, gx = c0 - 2 + c;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = xb[((size_t)gy * W + gx) * ci + ch];
    x_s[(r * xc + c) * cip + ch] = v;
  }
  __syncthreads();

  // h1 at rows [r0-1, r0+th+1), columns [c0-1, c0+tw+1); 0 outside the image
  conv3x3(x_s, xc, cip, ci, hr, hc, 1, 1, w1, co, [&](int oy, int ox, int oc0, const float(&acc)[OCB]) {
    const int gy = r0 - 1 + oy, gx = c0 - 1 + ox;
    float* dst = h1_s + (oy * hc + ox) * cop + oc0;
    if (gy < 0 || gy >= H || gx < 0 || gx >= W) {
#pragma unroll
      for (int j = 0; j < OCB; ++j) dst[j] = 0.f;
      return;
    }
    float fac[OCB];
    if constexpr (DROP) site_factors(fac, d, 1, d.bits + ((size_t)gy * W + gx) * co + oc0, d.fchan + oc0);
#pragma unroll
    for (int j = 0; j < OCB; ++j) {
      float v = fmaxf(acc[j] + b1[oc0 + j], 0.f);
      if constexpr (DROP) v *= fac[j];
      dst[j] = v;
    }
  });
  __syncthreads();

  // y2 on the tile: stored to device memory and to the y2 tile
  float* y2_s = x_s;
  float* y2b = y2 + (size_t)b * H * W * co;
  conv3x3(h1_s, hc, cop, co, th, tw, 1, 1, w2, co, [&](int oy, int ox, int oc0, const float(&acc)[OCB]) {
    const int gy = r0 + oy, gx = c0 + ox;
    float* dst = y2_s + (oy * tw + ox) * co + oc0;
    float v[OCB];
    if (gy >= H || gx >= W) {
#pragma unroll
      for (int j = 0; j < OCB; ++j) dst[j] = 0.f;
      return;
    }
    float fac[OCB];
    if constexpr (DROP) site_factors(fac, d, 2, d.bits + ((size_t)gy * W + gx) * co + oc0, d.fchan + oc0);
#pragma unroll
    for (int j = 0; j < OCB; ++j) {
      v[j] = fmaxf(acc[j] + b2[oc0 + j], 0.f);
      if constexpr (DROP) v[j] *= fac[j];
      dst[j] = v[j];
    }
    store16(y2b + ((size_t)gy * W + gx) * co + oc0, v);
  });
  __syncthreads();

  // per-channel sums of the tile, in a fixed order: thread (part, c) adds
  // pixels part, part + nparts, ...; then the parts in order
  const int nparts = blockDim.x / co, c = threadIdx.x % co, part = threadIdx.x / co;
  float s1 = 0.f, s2 = 0.f;
  if (part < nparts) {
    for (int p = part; p < th * tw; p += nparts) {
      const float v = y2_s[p * co + c];
      s1 += v;
      s2 += v * v;
    }
  }
  red_s[threadIdx.x] = s1;
  red_s[blockDim.x + threadIdx.x] = s2;
  __syncthreads();
  if (threadIdx.x < co) {
    float t1 = 0.f, t2 = 0.f;
    for (int q = 0; q < nparts; ++q) {
      t1 += red_s[q * co + c];
      t2 += red_s[blockDim.x + q * co + c];
    }
    float* dst = partial + ((size_t)b * n_tiles + tile) * 2 * co;
    dst[c] = t1;
    dst[co + c] = t2;
  }
}

__host__ __device__ __forceinline__ int align16(int bytes) { return (bytes + 15) & ~15; }

// Shared memory of the bf16 kernel: the x tile (bf16 for the tensor-core
// conv1, float for the CUDA-core one), reused for the bf16 y2 tile; h1;
// the statistics scratch.
__host__ __device__ __forceinline__ int k1_mma_x_bytes(bool mma1, int ci, int th, int tw) {
  return (th + 4) * (tw + 4) * (mma1 ? mma_stride(ci) * 2 : odd_stride(ci) * 4);
}

__host__ __device__ __forceinline__ int k1_mma_h1_offset(bool mma1, int ci, int co, int th, int tw) {
  const int x_bytes = k1_mma_x_bytes(mma1, ci, th, tw), y2_bytes = th * tw * co * 2;
  return align16(x_bytes > y2_bytes ? x_bytes : y2_bytes);
}

static int k1_mma_smem_bytes(bool mma1, int ci, int co, int th, int tw) {
  return k1_mma_h1_offset(mma1, ci, co, th, tw) + align16((th + 2) * (tw + 2) * mma_stride(co) * 2) +
         2 * K1_THREADS * 4;
}

// The bf16 kernel: the same function as fused_stem_k1_kernel with y2 and
// h1 rounded to bf16, conv2 (and conv1 when ci % 16 == 0, MMA1) on the
// tensor cores; conv1 of
// the first stem block (ci = 1, 144 products a pixel) stays on the CUDA
// cores. Tiles live in shared memory as bf16, the sums are float32.
template <bool DROP, bool MMA1, int NT>
__global__ void __launch_bounds__(K1_THREADS)
fused_stem_k1_mma_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ bits,
                         const float* __restrict__ fchan, const int* __restrict__ scal, const bf16* __restrict__ w1,
                         const uint4* __restrict__ w1f, const bf16* __restrict__ b1, const uint4* __restrict__ w2f,
                         const bf16* __restrict__ b2, bf16* __restrict__ y2, float* __restrict__ partial, int H,
                         int W, int ci, int co, int th, int tw, int t_keep, float inv_e) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tiles_w = cdiv(W, tw), n_tiles = cdiv(H, th) * tiles_w;
  const int tile = blockIdx.x, b = blockIdx.y;
  const int r0 = (tile / tiles_w) * th, c0 = (tile % tiles_w) * tw;
  const int xc = tw + 4, hr = th + 2, hc = tw + 2, hs = mma_stride(co);
  bf16* h1_s = reinterpret_cast<bf16*>(smem_raw + k1_mma_h1_offset(MMA1, ci, co, th, tw));
  float* red_s = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(h1_s) + align16(hr * hc * hs * 2));

  Drop d{nullptr, nullptr, 0, 0, t_keep, inv_e};
  if constexpr (DROP) {
    d.bits = bits + (size_t)b * H * W * co;
    d.fchan = fchan + (size_t)b * co;
    d.pos = scal[0];
    d.use_elem = scal[1];
  }

  // x rows [r0-2, r0+th+2), columns [c0-2, c0+tw+2), zero outside the image
  const bf16* xb = x + (size_t)b * H * W * ci;
  if constexpr (MMA1) {
    bf16* x_s = reinterpret_cast<bf16*>(smem_raw);
    const int xs = mma_stride(ci), nv = ci / 8;  // 16-byte vectors a pixel
    for (int i = threadIdx.x; i < (th + 4) * xc * nv; i += blockDim.x) {
      const int r = i / (xc * nv), rem = i % (xc * nv), c = rem / nv, v = rem % nv;
      const int gy = r0 - 2 + r, gx = c0 - 2 + c;
      uint4 q = make_uint4(0u, 0u, 0u, 0u);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) q = __ldg(reinterpret_cast<const uint4*>(xb + ((size_t)gy * W + gx) * ci) + v);
      *reinterpret_cast<uint4*>(x_s + (r * xc + c) * xs + v * 8) = q;
    }
  } else {
    float* x_s = reinterpret_cast<float*>(smem_raw);
    const int cip = odd_stride(ci);
    for (int i = threadIdx.x; i < (th + 4) * xc * ci; i += blockDim.x) {
      const int r = i / (xc * ci), rem = i % (xc * ci), c = rem / ci, ch = rem % ci;
      const int gy = r0 - 2 + r, gx = c0 - 2 + c;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = xb[((size_t)gy * W + gx) * ci + ch];
      x_s[(r * xc + c) * cip + ch] = v;
    }
  }
  __syncthreads();

  // h1 at rows [r0-1, r0+th+1), columns [c0-1, c0+tw+1); 0 outside the image
  auto h1_pair = [&](int oy, int ox, int oc, float v0, float v1) {
    const int gy = r0 - 1 + oy, gx = c0 - 1 + ox;
    bf16* dst = h1_s + (oy * hc + ox) * hs + oc;
    if (gy < 0 || gy >= H || gx < 0 || gx >= W) {
      store_bf2(dst, 0.f, 0.f);
      return;
    }
    v0 = fmaxf(v0 + to_f(b1[oc]), 0.f);
    v1 = fmaxf(v1 + to_f(b1[oc + 1]), 0.f);
    if constexpr (DROP) {
      float fac[2];
      site_factors2(fac, d, 1, d.bits + ((size_t)gy * W + gx) * co + oc, d.fchan + oc);
      v0 *= fac[0];
      v1 *= fac[1];
    }
    store_bf2(dst, v0, v1);
  };
  if constexpr (MMA1) {
    conv3x3_mma<NT>(reinterpret_cast<const bf16*>(smem_raw), xc, ci, hr, hc, 1, 1, w1f, co, h1_pair);
  } else {
    conv3x3(reinterpret_cast<const float*>(smem_raw), xc, odd_stride(ci), ci, hr, hc, 1, 1, w1, co,
            [&](int oy, int ox, int oc0, const float(&acc)[OCB]) {
#pragma unroll
              for (int j = 0; j < OCB; j += 2) h1_pair(oy, ox, oc0 + j, acc[j], acc[j + 1]);
            });
  }
  __syncthreads();

  // y2 on the tile: stored to device memory and to the y2 tile (bf16)
  bf16* y2_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* y2b = y2 + (size_t)b * H * W * co;
  conv3x3_mma<NT>(h1_s, hc, co, th, tw, 1, 1, w2f, co, [&](int oy, int ox, int oc, float v0, float v1) {
    const int gy = r0 + oy, gx = c0 + ox;
    bf16* dst = y2_s + (oy * tw + ox) * co + oc;
    if (gy >= H || gx >= W) {
      store_bf2(dst, 0.f, 0.f);
      return;
    }
    v0 = fmaxf(v0 + to_f(b2[oc]), 0.f);
    v1 = fmaxf(v1 + to_f(b2[oc + 1]), 0.f);
    if constexpr (DROP) {
      float fac[2];
      site_factors2(fac, d, 2, d.bits + ((size_t)gy * W + gx) * co + oc, d.fchan + oc);
      v0 *= fac[0];
      v1 *= fac[1];
    }
    store_bf2(dst, v0, v1);
    store_bf2(y2b + ((size_t)gy * W + gx) * co + oc, v0, v1);
  });
  __syncthreads();

  const int nparts = blockDim.x / co, c = threadIdx.x % co, part = threadIdx.x / co;
  float s1 = 0.f, s2 = 0.f;
  if (part < nparts) {
    for (int p = part; p < th * tw; p += nparts) {
      const float v = to_f(y2_s[p * co + c]);
      s1 += v;
      s2 += v * v;
    }
  }
  red_s[threadIdx.x] = s1;
  red_s[blockDim.x + threadIdx.x] = s2;
  __syncthreads();
  if (threadIdx.x < co) {
    float t1 = 0.f, t2 = 0.f;
    for (int q = 0; q < nparts; ++q) {
      t1 += red_s[q * co + c];
      t2 += red_s[blockDim.x + q * co + c];
    }
    float* dst = partial + ((size_t)b * n_tiles + tile) * 2 * co;
    dst[c] = t1;
    dst[co + c] = t2;
  }
}

// stats[b, k] = sum over tiles of partial[b, tile, k] (k = stat * co + c),
// in a fixed order: thread (part, k) adds tiles part, part + nparts, ...;
// then the parts in order.
__global__ void __launch_bounds__(STATS_THREADS)
fused_stem_k1_stats_kernel(const float* __restrict__ partial, float* __restrict__ stats, int n_tiles, int n) {
  __shared__ float red_s[STATS_THREADS];
  const int b = blockIdx.x, nparts = STATS_THREADS / n, k = threadIdx.x % n, part = threadIdx.x / n;
  float s = 0.f;
  if (part < nparts) {
    const float* p = partial + (size_t)b * n_tiles * n + k;
#pragma unroll 4
    for (int i = part; i < n_tiles; i += nparts) s += p[(size_t)i * n];
  }
  red_s[threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.x < n) {
    float t = 0.f;
    for (int q = 0; q < nparts; ++q) t += red_s[q * n + k];
    stats[(size_t)b * n + k] = t;
  }
}

// Dynamic shared memory of one block, in bytes (the wrapper checks it too).
static int k1_smem_bytes(int ci, int co, int th, int tw) {
  const int x_floats = (th + 4) * (tw + 4) * odd_stride(ci), y2_floats = th * tw * co;
  return ((x_floats > y2_floats ? x_floats : y2_floats) + (th + 2) * (tw + 2) * odd_stride(co) + 2 * K1_THREADS) * 4;
}

template <bool DROP>
static int launch(const void* x, const void* bits, const void* fchan, const void* scal, const void* w1,
                  const void* b1, const void* w2, const void* b2, void* y2, void* partial, int B, int H, int W,
                  int ci, int co, int th, int tw, int t_keep, float inv_e, cudaStream_t stream) {
  const int smem = k1_smem_bytes(ci, co, th, tw);
  auto kern = fused_stem_k1_kernel<DROP>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(cdiv(H, th) * cdiv(W, tw), B), K1_THREADS, smem, stream>>>(
      (const float*)x, (const uint8_t*)bits, (const float*)fchan, (const int*)scal, (const float*)w1, (const float*)b1,
      (const float*)w2, (const float*)b2, (float*)y2, (float*)partial, H, W, ci, co, th, tw, t_keep, inv_e);
  return (int)cudaGetLastError();
}

template <bool DROP, bool MMA1, int NT>
static int launch_mma(const void* x, const void* bits, const void* fchan, const void* scal, const void* w1,
                      const void* w1f, const void* b1, const void* w2f, const void* b2, void* y2, void* partial,
                      int B, int H, int W, int ci, int co, int th, int tw, int t_keep, float inv_e,
                      cudaStream_t stream) {
  const int smem = k1_mma_smem_bytes(MMA1, ci, co, th, tw);
  auto kern = fused_stem_k1_mma_kernel<DROP, MMA1, NT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(cdiv(H, th) * cdiv(W, tw), B), K1_THREADS, smem, stream>>>(
      (const bf16*)x, (const uint8_t*)bits, (const float*)fchan, (const int*)scal, (const bf16*)w1,
      (const uint4*)w1f, (const bf16*)b1, (const uint4*)w2f, (const bf16*)b2, (bf16*)y2, (float*)partial, H, W,
      ci, co, th, tw, t_keep, inv_e);
  return (int)cudaGetLastError();
}

template <bool DROP>
static int launch_bf16(const void* x, const void* bits, const void* fchan, const void* scal, const void* w1,
                       const void* w1f, const void* b1, const void* w2f, const void* b2, void* y2, void* partial,
                       int B, int H, int W, int ci, int co, int th, int tw, int t_keep, float inv_e,
                       cudaStream_t stream) {
#define K1_MMA_ARGS x, bits, fchan, scal, w1, w1f, b1, w2f, b2, y2, partial, B, H, W, ci, co, th, tw, t_keep, inv_e, stream
  const bool mma1 = ci % 16 == 0;
  if (co % 32 == 0)
    return mma1 ? launch_mma<DROP, true, 4>(K1_MMA_ARGS) : launch_mma<DROP, false, 4>(K1_MMA_ARGS);
  return mma1 ? launch_mma<DROP, true, 2>(K1_MMA_ARGS) : launch_mma<DROP, false, 2>(K1_MMA_ARGS);
#undef K1_MMA_ARGS
}

// dtype: 0 float32 (CUDA cores), 1 bfloat16 (tensor cores; w1f/w2f are
// the weights in mma fragment order, w1f only used when ci % 16 == 0). co
// must be a multiple of 16 that divides 256; x [B, H, W, ci], bits [B, H,
// W, co] (null without dropout), fchan [B, co], scal int32 {pos, use_elem}
// on the device, partial [B, n_tiles, 2, co] scratch, stats [B, 2, co].
extern "C" int fused_stem_k1_launch(const void* x, const void* bits, const void* fchan, const void* scal,
                                    const void* w1, const void* w1f, const void* b1, const void* w2,
                                    const void* w2f, const void* b2, void* y2, void* partial, void* stats, int dtype,
                                    int has_drop, int B, int H, int W, int ci, int co, int th, int tw, int t_keep,
                                    float inv_e, void* stream) {
  if (co % OCB || K1_THREADS % co || 2 * co > STATS_THREADS) return (int)cudaErrorInvalidValue;
  const int smem = dtype == 0 ? k1_smem_bytes(ci, co, th, tw) : k1_mma_smem_bytes(ci % 16 == 0, ci, co, th, tw);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err;
#define K1_ARGS x, bits, fchan, scal, w1, b1, w2, b2, y2, partial, B, H, W, ci, co, th, tw, t_keep, inv_e, s
#define K1_BF16_ARGS x, bits, fchan, scal, w1, w1f, b1, w2f, b2, y2, partial, B, H, W, ci, co, th, tw, t_keep, inv_e, s
  if (dtype == 0)
    err = has_drop ? launch<true>(K1_ARGS) : launch<false>(K1_ARGS);
  else if (dtype == 1)
    err = has_drop ? launch_bf16<true>(K1_BF16_ARGS) : launch_bf16<false>(K1_BF16_ARGS);
  else
    return (int)cudaErrorInvalidValue;
#undef K1_ARGS
#undef K1_BF16_ARGS
  if (err != 0) return err;
  fused_stem_k1_stats_kernel<<<B, STATS_THREADS, 0, s>>>((const float*)partial, (float*)stats,
                                                          cdiv(H, th) * cdiv(W, tw), 2 * co);
  return (int)cudaGetLastError();
}
