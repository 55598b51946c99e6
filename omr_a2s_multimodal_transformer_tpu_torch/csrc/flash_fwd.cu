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
// K1 (flash_fwd_tma_kernel, then flash_fwd_tma_merge_kernel when the keys
// are split) is built for Hopper. What bounds it on the H100: the two
// products, 4*B*H*Lq*Lk*64 FLOP (0.11 ms at the flagship cross shape),
// against ~5e8 scores that each cost an exp on the special-function units
// (~0.14 ms) and, with dropout, the keep-mask hash on the integer pipes
// (~10 ALU operations a score, ~0.3 ms): the CUDA cores, not the tensor
// cores, set its floor. The design is the block of flash_fwd.cuh, which L1
// and L2a (legacy_flash_fwd.cu) share for the per-head layout: a producer
// warp feeding a 4-stage TMA ring of 64-key K/V tiles, with each key tile's
// mask as an additive 0 / -1e30 bias and the hash's column terms, to three
// consumer warpgroups of 64 queries (setmaxnreg; three rather than two:
// while one runs its softmax and hash on the CUDA cores, the others'
// products and waits fill the SM, and three were faster than two at dropout
// 0.1 on the H100), both products on wgmma; and no wave tail: one block
// fills an SM, so the key tiles are split into a few chunks (chosen by the
// wrapper for the SM count, fwd_splits) whose partial (o, lse) a merge
// kernel combines by lse.
//
// K1c (flash_fwd_causal_kernel) keeps the mma.sync design: one block of 4
// warps per (64-query tile, head, batch row), online softmax in the log2
// domain, ldmatrix fragments and cp.async double buffers, and it walks only
// the 64-key tiles of its band (key_tiles). The TPU kernel skipped whole JAX
// blocks (_window_blocks); the per-score key test makes both give the same
// o and lse on every row that has a key to see. At the paper's window (100)
// a query sees at most 101 keys, ~50 FLOP/byte, so bytes bound it; at the
// paper shape launch latency and the 2-4 key tiles a 64-query tile walks
// set its time.
#include "flash_fwd.cuh"

using namespace flash;

__global__ void __launch_bounds__(NT)
flash_fwd_causal_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                        const int* __restrict__ kv_len, const uint8_t* __restrict__ kv_valid,
                        const int* __restrict__ seed_p, bf16* __restrict__ o, float* __restrict__ lse, int H,
                        int Lq, int Lk, int mbq, int mbk, int window, float rate, float keep_scale,
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
  key_tiles<true>(q0, (Lk + BK - 1) / BK, window, kt_lo, kt_hi);
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
        const bool see = valid[kc] && in_band<true>(qrow[e >> 1], k0 + kc, window);
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

// ------------------------------------------------------------------- K1

constexpr int K1_NCONS = 3;  // consumer warpgroups of 64 queries
constexpr int K1_THREADS = 128 * (K1_NCONS + 1);
constexpr int K1_ROWS = 64 * K1_NCONS;  // queries per block

// grid (ceil(Lq / 192), H, B * n_split); k1::fwd_block on the head-packed
// layout at head width 64 (scale 1/8), with dropout. Block z = b * n_split +
// split walks key tiles [split * per, min(n_tiles, (split + 1) * per)).
// n_split == 1 writes o (bf16) and lse; otherwise the normalized partial o
// (f32, [n_split, B, Lq, H*64]) and its lse ([n_split, B, H, Lq]) for the
// merge kernel.
__global__ void __launch_bounds__(K1_THREADS, 1)
flash_fwd_tma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const int* __restrict__ kv_len,
                     const uint8_t* __restrict__ kv_valid, const int* __restrict__ seed_p, bf16* __restrict__ o,
                     float* __restrict__ lse, float* __restrict__ o_part, float* __restrict__ lse_part, int B, int H,
                     int Lq, int Lk, int mbq, int mbk, int n_split, int per, float rate, float keep_scale,
                     uint32_t thresh) {
  k1::fwd_block<K1_NCONS, false, false, 1, true, true>(&tq, &tk, &tv, kv_len, kv_valid, seed_p, o, lse, o_part,
                                                       lse_part, B, H, Lq, Lk, DH, mbq, mbk, -1, n_split, per, 0.125f,
                                                       rate, keep_scale, thresh);
}

// The merge of K1's key chunks: per (b, q, h), lse = log sum_i exp(lse_i)
// and o = sum_i exp(lse_i - lse) o_i, rounded to bf16.
__global__ void __launch_bounds__(k1::MERGE_THREADS)
flash_fwd_tma_merge_kernel(const float* __restrict__ o_part, const float* __restrict__ lse_part,
                           bf16* __restrict__ o, float* __restrict__ lse, int B, int H, int Lq, int n_split) {
  k1::merge_packed(o_part, lse_part, o, lse, B, H, Lq, n_split);
}

// causal: K1c (o_part, lse_part, n_split and per are ignored). Otherwise K1
// with the keys in n_split chunks of `per` 64-key tiles (the wrapper's
// fwd_splits); o_part and lse_part are its scratch when n_split > 1.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, const void* kv_len,
                                const void* kv_valid, const void* seed, void* o, void* lse, void* o_part,
                                void* lse_part, int B, int H, int Lq, int Lk, int mbq, int mbk, int causal,
                                int window, int n_split, int per, float rate, float keep_scale, unsigned int thresh,
                                void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (causal) {
    dim3 grid((Lq + BQ - 1) / BQ, H, B);
    flash_fwd_causal_kernel<<<grid, NT, 0, st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)kv_len, (const uint8_t*)kv_valid,
        (const int*)seed, (bf16*)o, (float*)lse, H, Lq, Lk, mbq, mbk, window, rate, keep_scale, thresh);
    return (int)cudaGetLastError();
  }
  if (!k1::valid_split(Lk, 0, n_split, per, o_part, lse_part)) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  int err = hopper::make_map_bf16(&tq, q, B, Lq, H * DH, 64);
  if (!err) err = hopper::make_map_bf16(&tk, k, B, Lk, H * DH, 64);
  if (!err) err = hopper::make_map_bf16(&tv, v, B, Lk, H * DH, 64);
  if (err) return err;
  constexpr int K1_SMEM = k1::smem_bytes<K1_NCONS, 1>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(flash_fwd_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K1_SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid((Lq + K1_ROWS - 1) / K1_ROWS, H, B * n_split);
  flash_fwd_tma_kernel<<<grid, K1_THREADS, K1_SMEM, st>>>(
      tq, tk, tv, (const int*)kv_len, (const uint8_t*)kv_valid, (const int*)seed, (bf16*)o, (float*)lse,
      (float*)o_part, (float*)lse_part, B, H, Lq, Lk, mbq, mbk, n_split, per, rate, keep_scale, thresh);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return (int)e;
  const size_t n = (size_t)B * Lq * H * 16;
  flash_fwd_tma_merge_kernel<<<(unsigned)((n + k1::MERGE_THREADS - 1) / k1::MERGE_THREADS), k1::MERGE_THREADS, 0,
                               st>>>(
      (const float*)o_part, (const float*)lse_part, (bf16*)o, (float*)lse, B, H, Lq, n_split);
  return (int)cudaGetLastError();
}
