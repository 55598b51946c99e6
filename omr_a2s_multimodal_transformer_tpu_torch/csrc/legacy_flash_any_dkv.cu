// L2c for any float type and head width: dk and dv of the per-head flash
// backward.
//
// Replaces, for what the bf16 templates of legacy_flash_dkv.cu do not take
// (float16, float32, heads wider than 128 or misaligned rows),
// tools/legacy_flash/flash_attention_bwd.py _dkv_kernel (pallas_call :360).
// With p = exp(s - lse) on the (query, key) pairs a query sees and ds = p *
// (do v^T - delta): dv = p^T do, dk = ds^T q * scale. One warp per (b, h,
// key): lanes take 32 queries at a time (s and dp as float32 dot products),
// then the warp accumulates p do and ds q into the key's two D-float rows
// in shared memory. Each row is written once: deterministic.
//
// What bounds it on the H100: the four products on the CUDA cores and the
// q and do rows each warp re-reads from L2 (the simple route).
#include "legacy_flash_any.cuh"

using namespace lfany;

// shared memory per warp: k, v, dk and dv accumulators (D floats each), p and ds of 32 queries
template <typename T>
__global__ void lfany_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                                 const int* __restrict__ kv_len, const uint8_t* __restrict__ kv_valid,
                                 const T* __restrict__ dout, const float* __restrict__ lse,
                                 const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int H,
                                 int Lq, int Lk, int D, int causal, int window, float scale, long rows) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * (blockDim.x >> 5) + warp;  // (b * H + h) * Lk + key
  if (row >= rows) return;
  float* sk = smem + (size_t)warp * (4 * D + 64);
  float* sv = sk + D;
  float* sdk = sv + D;
  float* sdv = sdk + D;
  float* sp = sdv + D;
  float* sds = sp + 32;
  const int ki = (int)(row % Lk);
  const long bh = row / Lk;
  const int b = (int)(bh / H);
  const T* qb = q + bh * Lq * D;
  const T* dob = dout + bh * Lq * D;
  const float* lse_b = lse + bh * Lq;
  const float* delta_b = delta + bh * Lq;
  for (int d = lane; d < D; d += 32) {
    sk[d] = to_f(k[row * D + d]);
    sv[d] = to_f(v[row * D + d]);
    sdk[d] = sdv[d] = 0.f;
  }
  __syncwarp();
  const int len = min(kv_len[b], Lk);
  int lo = 0, hi = key_ok(kv_valid + (size_t)b * Lk, len, ki) ? Lq : 0;  // an invalid key gets no gradient
  if (causal) {
    lo = ki;
    if (window > 0) hi = min(hi, ki + window + 1);
  }
  for (int q0 = lo; q0 < hi; q0 += 32) {
    const int qq = q0 + lane;
    float p = 0.f, ds = 0.f;
    if (qq < hi && in_band(causal, window, qq, ki)) {
      p = expf(dot_row(sk, qb + (size_t)qq * D, D) * scale - lse_b[qq]);
      ds = p * (dot_row(sv, dob + (size_t)qq * D, D) - delta_b[qq]);
    }
    sp[lane] = p;
    sds[lane] = ds;
    __syncwarp();
    const int nq = min(32, hi - q0);
    for (int d = lane; d < D; d += 32) {
      float a = sdv[d], c = sdk[d];
      for (int j = 0; j < nq; ++j) {
        a = fmaf(sp[j], to_f(dob[(size_t)(q0 + j) * D + d]), a);
        c = fmaf(sds[j], to_f(qb[(size_t)(q0 + j) * D + d]), c);
      }
      sdv[d] = a;
      sdk[d] = c;
    }
    __syncwarp();
  }
  for (int d = lane; d < D; d += 32) {
    dk[row * D + d] = from_f<T>(sdk[d] * scale);
    dv[row * D + d] = from_f<T>(sdv[d]);
  }
}

template <typename T>
static int dkv_run(const void* q, const void* k, const void* v, const void* kv_len, const void* kv_valid,
                   const void* dout, const void* lse, const void* delta, void* dk, void* dv, int B, int H, int Lq,
                   int Lk, int D, int causal, int window, float scale, void* stream) {
  const long rows = (long)B * H * Lk;
  return launch_rows(&lfany_dkv_kernel<T>, rows, 4 * D + 64, stream, (const T*)q, (const T*)k, (const T*)v,
                     (const int*)kv_len, (const uint8_t*)kv_valid, (const T*)dout, (const float*)lse,
                     (const float*)delta, (T*)dk, (T*)dv, H, Lq, Lk, D, causal, window, scale, rows);
}

// dtype: 0 bf16, 1 f16, 2 f32.
extern "C" int lfany_dkv_launch(const void* q, const void* k, const void* v, const void* kv_len,
                                const void* kv_valid, const void* dout, const void* lse, const void* delta, void* dk,
                                void* dv, int dtype, int B, int H, int Lq, int Lk, int D, int causal, int window,
                                float scale, void* stream) {
  if (D <= 0) return (int)cudaErrorInvalidValue;
  return LFANY_DISPATCH(dtype, dkv_run, q, k, v, kv_len, kv_valid, dout, lse, delta, dk, dv, B, H, Lq, Lk, D, causal,
                        window, scale, stream);
}
