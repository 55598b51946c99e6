// K1 / K1c: head-packed flash attention forward with attention-weight
// dropout, non-causal (K1) or causal with an optional window (K1c).
//
// Replaces omr_a2s_multimodal_transformer_tpu/ops/flash_packed.py
// _fwd_kernel, launched from make_flash_attention_packed._fwd_impl: K1 is
// its non-causal call (the decoder's cross-attention), K1c its call with
// causal=True and window (:177-185). Per head h:
//   o   = (softmax(q k^T / 8) * M / (1 - p)) v,   M = dropout keep-mask
//   lse = log-sum-exp of the masked scores (f32, [B, H, Lq])
// keys masked where !kv_valid[b, k] or k >= kv_len[b], and for K1c where
// k > q or k < q - window (score -> -1e30).
//
// One block of 4 warps per (64-query tile, head, batch row); each warp owns
// 16 queries and walks the key tiles of 64 with an online softmax in f32
// (kept in the log2 domain, so each score costs one ex2). Both products run
// on the tensor cores as bf16 mma.sync m16n8k16 with f32 accumulation, fed
// by ldmatrix; p is rounded to bf16 before the PV product, as in the TPU
// kernel. The score tile never leaves registers: its accumulator layout is
// re-used as the A operand of the PV product. K/V tiles are double-buffered
// with cp.async, so the next tile's copy overlaps this tile's math. K1c
// walks only the key tiles of its band (key_tiles): the 64-key tiles wholly
// above the diagonal or below q0 - window are never loaded. The TPU kernel
// skipped whole JAX blocks (_window_blocks); the per-score key test makes
// both give the same o and lse on every row that has a key to see.
//
// What bounds it on the H100: the two products are 4*B*H*Lq*Lk*64 FLOP
// against about 2*B*Lk*256*2 bytes of K/V, far above the card's ~295
// FLOP/byte balance point, so tensor-core FLOPs bound K1. Here the CUDA
// cores set the pace first: per score an exp, the online-softmax update
// and, with dropout, the keep-mask hash (~5e8 scores per flagship call).
// K1c at the paper's window (100) sees at most 101 keys per query: about
// 2.6e4 FLOP against 512 bytes of q, k, v and o per query and head, ~50
// FLOP/byte, so bytes bound it; at the paper shape (8 x 1268 queries, a
// few microseconds of traffic) launch latency and the 2-4 key tiles each
// 64-query tile walks set its time.
// The design hoists every per-score multiply and modulo of the hash out of
// the loop and multiplies by 1/(1-p); wgmma/TMA and warp specialisation
// are later work.
#include "flash_common.cuh"

using namespace flash;

template <bool CAUSAL>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                 const int* __restrict__ kv_len, const uint8_t* __restrict__ kv_valid,
                 const int* __restrict__ seed_p, bf16* __restrict__ o, float* __restrict__ lse,
                 int H, int Lq, int Lk, int mbq, int mbk, int window, float rate, float keep_scale,
                 uint32_t thresh) {
  __shared__ __align__(16) bf16 sQ[TILE];
  __shared__ __align__(16) bf16 sK[2][TILE];
  __shared__ __align__(16) bf16 sV[2][TILE];
  __shared__ uint8_t sValid[2][BK];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int ld = H * DH;
  const int q0 = qt * BQ;
  const bf16* qb = q + (size_t)b * Lq * ld + h * DH;
  const bf16* kb = k + (size_t)b * Lk * ld + h * DH;
  const bf16* vb = v + (size_t)b * Lk * ld + h * DH;
  const uint8_t* validb = kv_valid + (size_t)b * Lk;
  const int len = min(kv_len[b], Lk);
  const bool dropout = rate > 0.f;
  const int seed = dropout ? *seed_p : 0;
  const float scale_log2 = 0.125f * LOG2E;  // 1/sqrt(64), in the log2 domain
  int kt_lo, kt_hi;
  key_tiles<CAUSAL>(q0, (Lk + BK - 1) / BK, window, kt_lo, kt_hi);
  const int n_iter = kt_hi - kt_lo + 1;  // <= 0: no key tile to see; o = 0, lse = 0

  auto issue_kv = [&](int kt, int buf) {
    const int k0 = kt * BK;
    load_tile_async(sK[buf], kb, k0, Lk, ld, tid);
    load_tile_async(sV[buf], vb, k0, Lk, ld, tid);
    cp_async_commit();
    if (tid < BK) {
      const int kk = k0 + tid;
      sValid[buf][tid] = key_valid(validb, len, kk) ? 1 : 0;
    }
  };

  if (n_iter > 0) {
    load_tile_async(sQ, qb, q0, Lq, ld, tid);
    issue_kv(kt_lo, 0);  // commits Q and the first K/V tile as one group
  }

  // rows owned by this thread: r = 0 -> query q0+warp*16+g, r = 1 -> +8
  float m_r[2] = {NEG_INF, NEG_INF};  // running max, log2 domain
  float l_r[2] = {0.f, 0.f};
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int qrow[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  // hash row terms; q tiles of 64 lie inside one mask q-block (mbq % 64 == 0)
  const uint32_t row_term[2] = {(uint32_t)(h * mbq + qrow[0] % mbq) * ROW_MUL,
                                (uint32_t)(h * mbq + qrow[1] % mbq) * ROW_MUL};
  uint32_t qf[4][4];

  for (int it = 0; it < n_iter; ++it) {
    const int kt = kt_lo + it;
    const int buf = it & 1;
    const int k0 = kt * BK;
    if (it + 1 < n_iter) {
      issue_kv(kt + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) load_a_frags(qf, sQ, warp * 16, lane);
    const bf16* K = sK[buf];
    const bf16* V = sV[buf];
    const uint8_t* valid = sValid[buf];

    // s = q k^T for 16 queries x 64 keys (8 tiles of 8 keys)
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      uint32_t bfr[4][2];
      load_bt_frags(bfr, K, j * 8, lane);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) mma16816(s[j], qf[kk], bfr[kk]);
    }

    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = j * 8 + 2 * t + (e & 1);
        const bool see = valid[kc] && in_band<CAUSAL>(qrow[e >> 1], k0 + kc, window);
        const float x = see ? s[j][e] * scale_log2 : NEG_INF;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(s[j][e] - mx[e >> 1]);
        s[j][e] = p;
        rs[e >> 1] += p;
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      corr[r] = ex2(m_r[r] - mx[r]);
      l_r[r] = corr[r] * l_r[r] + rs[r];  // l excludes dropout
      m_r[r] = mx[r];
    }
    if (dropout) {
      // k tiles of 64 lie inside one mask k-block (mbk % 64 == 0)
      const uint32_t mixmul = block_mix(seed, b, q0 / mbq, k0 / mbk);
      const uint32_t col_term = (uint32_t)(k0 % mbk + 2 * t) * COL_MUL;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t x = mixmul ^ row_term[e >> 1] ^ (col_term + (uint32_t)(j * 8 + (e & 1)) * COL_MUL);
          s[j][e] = keep_bit(x, thresh) ? s[j][e] * keep_scale : 0.f;
        }
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
    // acc += p v: the score accumulators of key tiles 2kc, 2kc+1 are the A
    // fragment of the 16-key chunk kc.
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t a[4] = {pack_f2(s[2 * kc][0], s[2 * kc][1]), pack_f2(s[2 * kc][2], s[2 * kc][3]),
                       pack_f2(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                       pack_f2(s[2 * kc + 1][2], s[2 * kc + 1][3])};
      uint32_t bfr[8][2];
      load_b_frags(bfr, V, kc * 16, lane);
#pragma unroll
      for (int n = 0; n < 8; ++n) mma16816(acc[n], a, bfr[n]);
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qrow[r] >= Lq) continue;
    const float l = l_r[r];
    const float den = l == 0.f ? 1.f : l;
    bf16* orow = o + ((size_t)b * Lq + qrow[r]) * ld + h * DH;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * r] / den, acc[n][2 * r + 1] / den);
    }
    if (t == 0) lse[((size_t)b * H + h) * Lq + qrow[r]] = l == 0.f ? 0.f : m_r[r] * LN2 + logf(den);
  }
}

extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, const void* kv_len,
                                const void* kv_valid, const void* seed, void* o, void* lse, int B,
                                int H, int Lq, int Lk, int mbq, int mbk, int causal, int window,
                                float rate, float keep_scale, unsigned int thresh, void* stream) {
  dim3 grid((Lq + BQ - 1) / BQ, H, B);
  auto kernel = causal ? &flash_fwd_kernel<true> : &flash_fwd_kernel<false>;
  kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)kv_len, (const uint8_t*)kv_valid,
      (const int*)seed, (bf16*)o, (float*)lse, H, Lq, Lk, mbq, mbk, window, rate, keep_scale, thresh);
  return (int)cudaGetLastError();
}
