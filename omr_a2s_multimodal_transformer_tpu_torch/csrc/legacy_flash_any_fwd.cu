// L1 / L2a for any float type and head width: per-head flash attention
// forward, with the per-position key mask and lse when with_lse (L2a).
//
// Replaces, for what the bf16 templates of legacy_flash_fwd.cu do not take
// (float16, float32, heads wider than 128 or misaligned rows),
// tools/legacy_flash/flash_attention.py _kernel (L1, pallas_call :169) and
// tools/legacy_flash/flash_attention_bwd.py _fwd_kernel (L2a, :250), which
// take any float dtype and width. Same function: o = softmax(q k^T * scale +
// mask) v and lse = m + log(sum exp), o = 0 and lse = 0 on a row with no key
// to see. One warp per (b, h, query): lanes score 32 keys at a time in
// float32 (the online softmax in natural units, expf), then accumulate
// p v into the row's D floats in shared memory.
//
// What bounds it on the H100: the products on the CUDA cores (4*D FLOP per
// pair a query sees, 67 TFLOP/s in float32) and the key and value rows each
// warp re-reads from L2; it is the simple, exact route, not the fast one.
#include "legacy_flash_any.cuh"

using namespace lfany;

// shared memory per warp: q row (scaled), o accumulator (D floats each), p of 32 keys
template <typename T, bool LSE>
__global__ void lfany_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                                 const int* __restrict__ kv_len, const uint8_t* __restrict__ kv_valid,
                                 T* __restrict__ o, float* __restrict__ lse, int H, int Lq, int Lk, int D, int causal,
                                 int window, float scale, long rows) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * (blockDim.x >> 5) + warp;  // (b * H + h) * Lq + query
  if (row >= rows) return;  // whole warps only; no block-wide barrier follows
  float* sq = smem + (size_t)warp * (2 * D + 32);
  float* so = sq + D;
  float* sp = so + D;
  const int qi = (int)(row % Lq);
  const long bh = row / Lq;
  const int b = (int)(bh / H);
  const T* kb = k + bh * Lk * D;
  const T* vb = v + bh * Lk * D;
  for (int d = lane; d < D; d += 32) {
    sq[d] = to_f(q[row * D + d]) * scale;
    so[d] = 0.f;
  }
  __syncwarp();
  const uint8_t* valid_b = kv_valid == nullptr ? nullptr : kv_valid + (size_t)b * Lk;
  const int len = min(kv_len[b], Lk);
  int lo = 0, hi = len;
  if (causal) {
    hi = min(hi, qi + 1);
    if (window > 0) lo = max(0, qi - window);
  }
  float m = NEG_INF, l = 0.f;
  for (int k0 = lo; k0 < hi; k0 += 32) {
    const int kk = k0 + lane;
    float s = NEG_INF;
    if (kk < hi && key_ok(valid_b, len, kk) && in_band(causal, window, qi, kk)) s = dot_row(sq, kb + (size_t)kk * D, D);
    const float m_new = fmaxf(m, warp_max(s));
    if (m_new == NEG_INF) continue;  // no key seen yet (the same in every lane)
    const float p = s == NEG_INF ? 0.f : expf(s - m_new);
    const float corr = expf(m - m_new);  // 0 while m is NEG_INF
    l = l * corr + warp_sum(p);
    m = m_new;
    sp[lane] = p;
    __syncwarp();
    const int nk = min(32, hi - k0);
    for (int d = lane; d < D; d += 32) {
      float a = so[d] * corr;
      for (int j = 0; j < nk; ++j) a = fmaf(sp[j], to_f(vb[(size_t)(k0 + j) * D + d]), a);
      so[d] = a;
    }
    __syncwarp();
  }
  const float inv = l > 0.f ? 1.f / l : 0.f;
  for (int d = lane; d < D; d += 32) o[row * D + d] = from_f<T>(so[d] * inv);
  if (LSE && lane == 0) lse[row] = l > 0.f ? m + logf(l) : 0.f;
}

template <typename T>
static int fwd_run(const void* q, const void* k, const void* v, const void* kv_len, const void* kv_valid, void* o,
                   void* lse, int B, int H, int Lq, int Lk, int D, int causal, int window, int with_lse, float scale,
                   void* stream) {
  const long rows = (long)B * H * Lq;
  const int per_warp = 2 * D + 32;
  if (with_lse)
    return launch_rows(&lfany_fwd_kernel<T, true>, rows, per_warp, stream, (const T*)q, (const T*)k, (const T*)v,
                       (const int*)kv_len, (const uint8_t*)kv_valid, (T*)o, (float*)lse, H, Lq, Lk, D, causal, window,
                       scale, rows);
  return launch_rows(&lfany_fwd_kernel<T, false>, rows, per_warp, stream, (const T*)q, (const T*)k, (const T*)v,
                     (const int*)kv_len, (const uint8_t*)nullptr, (T*)o, (float*)nullptr, H, Lq, Lk, D, causal,
                     window, scale, rows);
}

// dtype: 0 bf16, 1 f16, 2 f32. with_lse = 0: L1 (kv_valid and lse ignored); 1: L2a.
extern "C" int lfany_fwd_launch(const void* q, const void* k, const void* v, const void* kv_len,
                                const void* kv_valid, void* o, void* lse, int dtype, int B, int H, int Lq, int Lk,
                                int D, int causal, int window, int with_lse, float scale, void* stream) {
  if (D <= 0 || (with_lse && (kv_valid == nullptr || lse == nullptr))) return (int)cudaErrorInvalidValue;
  return LFANY_DISPATCH(dtype, fwd_run, q, k, v, kv_len, kv_valid, o, lse, B, H, Lq, Lk, D, causal, window, with_lse,
                        scale, stream);
}
