// K3a: dq of the split flash attention backward.
//
// Replaces omr_a2s_multimodal_transformer_tpu/ops/flash_packed.py
// _dq_kernel (:228), which the JAX backward runs, before _dkv_kernel, for
// every causal, windowed or merged_bwd=False call (:581). Per head h, with
// p = exp(s - lse) on the keys the query may see (0 elsewhere), M the
// dropout keep-mask regenerated from the forward's hash and
// delta = rowsum(do * o) per (b, h, q) computed by the caller:
//   dp = (do v^T) * M / (1 - rate),  ds = p * (dp - delta) / 8,  dq = ds k
//
// One block of 4 warps per (64-query tile, head, batch row); each warp owns
// 16 queries. The Q and dO tiles are loaded once and kept as mma A
// fragments; the block walks the key tiles of its band (key_tiles: all of
// them for a non-causal call) with the K/V tiles double-buffered by
// cp.async. s = q k^T and dp = do v^T are bf16 mma.sync products with f32
// accumulation; ds is rounded to bf16 (as in the TPU kernel) and its
// accumulator layout is re-used as the A operand of dq += ds k, so no
// score leaves registers. dq accumulates in f32 registers over the band and
// is written once, in bf16: no atomics, so the result is deterministic
// (unlike K2's dq).
//
// What bounds it on the H100: three products, 6*H*64 FLOP per (query, key)
// pair the query sees. Non-causal at the cross shape that is far above the
// ~295 FLOP/byte balance point (tensor-core FLOPs bound it; the CUDA cores
// set the pace first, with an exp, the ds arithmetic and, with dropout, the
// keep-mask hash per score). At the paper's window (100) each query sees at
// most 101 keys against 768 bytes of q, k, v, do and dq per query and head,
// so bytes bound it. Every per-score multiply and modulo of the hash is
// hoisted out of the loop; wgmma/TMA are later work.
#include "flash_common.cuh"

using namespace flash;

// shared memory: Q, dO, K[2], V[2] tiles (bf16)
constexpr int DQ_SMEM = 6 * TILE * (int)sizeof(bf16);

template <bool CAUSAL>
__global__ void __launch_bounds__(NT)
flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                const int* __restrict__ kv_len, const uint8_t* __restrict__ kv_valid,
                const int* __restrict__ seed_p, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dq,
                int H, int Lq, int Lk, int mbq, int mbk, int window, float rate, float keep_scale,
                uint32_t thresh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + TILE;
  bf16* sK = sdO + TILE;  // [2][TILE]
  bf16* sV = sK + 2 * TILE;  // [2][TILE]
  __shared__ uint8_t sValid[2][BK];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int ld = H * DH;
  const int q0 = qt * BQ;
  const bf16* kb = k + (size_t)b * Lk * ld + h * DH;
  const bf16* vb = v + (size_t)b * Lk * ld + h * DH;
  const uint8_t* validb = kv_valid + (size_t)b * Lk;
  const int len = min(kv_len[b], Lk);
  const bool dropout = rate > 0.f;
  const int seed = dropout ? *seed_p : 0;
  const float scale = 0.125f;  // 1/sqrt(64)
  int kt_lo, kt_hi;
  key_tiles<CAUSAL>(q0, (Lk + BK - 1) / BK, window, kt_lo, kt_hi);
  const int n_iter = kt_hi - kt_lo + 1;  // <= 0: no key to see; dq = 0

  auto issue_kv = [&](int kt, int buf) {
    const int k0 = kt * BK;
    load_tile_async(sK + buf * TILE, kb, k0, Lk, ld, tid);
    load_tile_async(sV + buf * TILE, vb, k0, Lk, ld, tid);
    cp_async_commit();
    if (tid < BK) sValid[buf][tid] = key_valid(validb, len, k0 + tid) ? 1 : 0;
  };

  if (n_iter > 0) {
    load_tile_async(sQ, q + (size_t)b * Lq * ld + h * DH, q0, Lq, ld, tid);
    load_tile_async(sdO, dout + (size_t)b * Lq * ld + h * DH, q0, Lq, ld, tid);
    issue_kv(kt_lo, 0);  // commits Q, dO and the first K/V tile as one group
  }

  // rows owned by this thread: r = 0 -> query q0+warp*16+g, r = 1 -> +8
  const int qrow[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float lse2[2], dlt[2];  // lse in the log2 domain, delta
  uint32_t row_term[2];   // hash row terms; q tiles of 64 lie inside one mask q-block
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = qrow[r] < Lq;
    lse2[r] = in ? lse[((size_t)b * H + h) * Lq + qrow[r]] * LOG2E : 0.f;
    dlt[r] = in ? delta[((size_t)b * H + h) * Lq + qrow[r]] : 0.f;
    row_term[r] = (uint32_t)(h * mbq + qrow[r] % mbq) * ROW_MUL;
  }
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  uint32_t qf[4][4], df[4][4];

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
    if (it == 0) {
      load_a_frags(qf, sQ, warp * 16, lane);
      load_a_frags(df, sdO, warp * 16, lane);
    }
    const bf16* K = sK + buf * TILE;
    const bf16* V = sV + buf * TILE;
    const uint8_t* valid = sValid[buf];

    // s = q k^T and dp = do v^T for 16 queries x 64 keys (8 tiles of 8 keys)
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      uint32_t bk[4][2], bv[4][2];
      load_bt_frags(bk, K, j * 8, lane);
      load_bt_frags(bv, V, j * 8, lane);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        mma16816(s[j], qf[kk], bk[kk]);
        mma16816(dp[j], df[kk], bv[kk]);
      }
    }

    // k tiles of 64 lie inside one mask k-block (mbk % 64 == 0)
    const uint32_t mixmul = dropout ? block_mix(seed, b, q0 / mbq, k0 / mbk) : 0u;
    const uint32_t col_term = (uint32_t)(k0 % mbk + 2 * t) * COL_MUL;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kc = j * 8 + 2 * t + (e & 1);
        const bool see = valid[kc] && qrow[r] < Lq && in_band<CAUSAL>(qrow[r], k0 + kc, window);
        const float p = see ? ex2(s[j][e] * (scale * LOG2E) - lse2[r]) : 0.f;
        float d = dp[j][e];
        if (dropout) {
          const uint32_t x = mixmul ^ row_term[r] ^ (col_term + (uint32_t)(j * 8 + (e & 1)) * COL_MUL);
          d = keep_bit(x, thresh) ? d * keep_scale : 0.f;
        }
        s[j][e] = p * (d - dlt[r]) * scale;  // ds
      }
    }

    // dq += ds k: the ds accumulators of key tiles 2kc, 2kc+1 are the A
    // fragment of the 16-key chunk kc; k rows are the B operand.
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t a[4] = {pack_f2(s[2 * kc][0], s[2 * kc][1]), pack_f2(s[2 * kc][2], s[2 * kc][3]),
                       pack_f2(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                       pack_f2(s[2 * kc + 1][2], s[2 * kc + 1][3])};
      uint32_t bfr[8][2];
      load_b_frags(bfr, K, kc * 16, lane);
#pragma unroll
      for (int n = 0; n < 8; ++n) mma16816(acc[n], a, bfr[n]);
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qrow[r] >= Lq) continue;
    bf16* drow = dq + ((size_t)b * Lq + qrow[r]) * ld + h * DH;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(drow + n * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  }
}

extern "C" int flash_dq_launch(const void* q, const void* k, const void* v, const void* kv_len,
                               const void* kv_valid, const void* seed, const void* dout, const void* lse,
                               const void* delta, void* dq, int B, int H, int Lq, int Lk, int mbq,
                               int mbk, int causal, int window, float rate, float keep_scale,
                               unsigned int thresh, void* stream) {
  auto kernel = causal ? &flash_dq_kernel<true> : &flash_dq_kernel<false>;
  static bool configured[2] = {false, false};
  if (!configured[causal ? 1 : 0]) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_SMEM);
    if (err != cudaSuccess) return (int)err;
    configured[causal ? 1 : 0] = true;
  }
  dim3 grid((Lq + BQ - 1) / BQ, H, B);
  kernel<<<grid, NT, DQ_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)kv_len, (const uint8_t*)kv_valid,
      (const int*)seed, (const bf16*)dout, (const float*)lse, (const float*)delta, (bf16*)dq, H, Lq, Lk,
      mbq, mbk, window, rate, keep_scale, thresh);
  return (int)cudaGetLastError();
}
