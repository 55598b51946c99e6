// L2b for any float type and head width: dq of the per-head flash backward.
//
// Replaces, for what the bf16 templates of legacy_flash_dq.cu do not take
// (float16, float32, heads wider than 128 or misaligned rows),
// tools/legacy_flash/flash_attention_bwd.py _dq_kernel (pallas_call :328).
// With p = exp(s - lse) on the keys a query sees (0 elsewhere) and the
// caller's delta = rowsum(do * o): ds = p * (do v^T - delta), dq = ds k *
// scale. One warp per (b, h, query): lanes take 32 keys at a time (s and dp
// as float32 dot products), then the warp accumulates ds k into the row's D
// floats in shared memory. Each row is written once: deterministic.
//
// What bounds it on the H100: the three products on the CUDA cores and the
// key and value rows each warp re-reads from L2 (the simple route, as the
// forward's).
#include "legacy_flash_any.cuh"

using namespace lfany;

// shared memory per warp: q, do, dq accumulator (D floats each), ds of 32 keys
template <typename T>
__global__ void lfany_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                                const int* __restrict__ kv_len, const uint8_t* __restrict__ kv_valid,
                                const T* __restrict__ dout, const float* __restrict__ lse,
                                const float* __restrict__ delta, T* __restrict__ dq, int H, int Lq, int Lk, int D,
                                int causal, int window, float scale, long rows) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * (blockDim.x >> 5) + warp;  // (b * H + h) * Lq + query
  if (row >= rows) return;
  float* sq = smem + (size_t)warp * (3 * D + 32);
  float* sdo = sq + D;
  float* sdq = sdo + D;
  float* sds = sdq + D;
  const int qi = (int)(row % Lq);
  const long bh = row / Lq;
  const int b = (int)(bh / H);
  const T* kb = k + bh * Lk * D;
  const T* vb = v + bh * Lk * D;
  for (int d = lane; d < D; d += 32) {
    sq[d] = to_f(q[row * D + d]);
    sdo[d] = to_f(dout[row * D + d]);
    sdq[d] = 0.f;
  }
  __syncwarp();
  const uint8_t* valid_b = kv_valid + (size_t)b * Lk;
  const int len = min(kv_len[b], Lk);
  int lo = 0, hi = len;
  if (causal) {
    hi = min(hi, qi + 1);
    if (window > 0) lo = max(0, qi - window);
  }
  const float lse_r = lse[row], delta_r = delta[row];
  for (int k0 = lo; k0 < hi; k0 += 32) {
    const int kk = k0 + lane;
    float ds = 0.f;
    if (kk < hi && key_ok(valid_b, len, kk) && in_band(causal, window, qi, kk)) {
      const float p = expf(dot_row(sq, kb + (size_t)kk * D, D) * scale - lse_r);
      ds = p * (dot_row(sdo, vb + (size_t)kk * D, D) - delta_r);
    }
    sds[lane] = ds;
    __syncwarp();
    const int nk = min(32, hi - k0);
    for (int d = lane; d < D; d += 32) {
      float a = sdq[d];
      for (int j = 0; j < nk; ++j) a = fmaf(sds[j], to_f(kb[(size_t)(k0 + j) * D + d]), a);
      sdq[d] = a;
    }
    __syncwarp();
  }
  for (int d = lane; d < D; d += 32) dq[row * D + d] = from_f<T>(sdq[d] * scale);
}

template <typename T>
static int dq_run(const void* q, const void* k, const void* v, const void* kv_len, const void* kv_valid,
                  const void* dout, const void* lse, const void* delta, void* dq, int B, int H, int Lq, int Lk, int D,
                  int causal, int window, float scale, void* stream) {
  const long rows = (long)B * H * Lq;
  return launch_rows(&lfany_dq_kernel<T>, rows, 3 * D + 32, stream, (const T*)q, (const T*)k, (const T*)v,
                     (const int*)kv_len, (const uint8_t*)kv_valid, (const T*)dout, (const float*)lse,
                     (const float*)delta, (T*)dq, H, Lq, Lk, D, causal, window, scale, rows);
}

// dtype: 0 bf16, 1 f16, 2 f32.
extern "C" int lfany_dq_launch(const void* q, const void* k, const void* v, const void* kv_len, const void* kv_valid,
                               const void* dout, const void* lse, const void* delta, void* dq, int dtype, int B,
                               int H, int Lq, int Lk, int D, int causal, int window, float scale, void* stream) {
  if (D <= 0) return (int)cudaErrorInvalidValue;
  return LFANY_DISPATCH(dtype, dq_run, q, k, v, kv_len, kv_valid, dout, lse, delta, dq, B, H, Lq, Lk, D, causal,
                        window, scale, stream);
}
