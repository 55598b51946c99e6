// K3b: dk and dv of the split flash attention backward.
//
// Replaces omr_a2s_multimodal_transformer_tpu/ops/flash_packed.py
// _dkv_kernel (:283; windowed query range :296-301), which the JAX backward
// runs after _dq_kernel for every causal, windowed or merged_bwd=False call
// (:581). Per head h, with p = exp(s - lse) on the keys each query may see
// (0 elsewhere), M the dropout keep-mask regenerated from the forward's hash
// and delta = rowsum(do * o) per (b, h, q) computed by the caller, and the
// dropout handling of :316-325 (dv takes the dropped p, ds the undropped p
// with the dropped dp):
//   dp = (do v^T) * M / (1 - rate),  ds = p * (dp - delta) / 8
//   dv = (p * M / (1 - rate))^T do,  dk = ds^T q
//
// One block of 4 warps per (64-key tile, head, batch row) walks the query
// tiles that can see its keys (query_tiles: all of them for a non-causal
// call), with the Q/dO tiles double-buffered by cp.async. Each warp owns 16
// keys and works in the transposed frame (s^T = k q^T, dp^T = v do^T), so
// dk and dv accumulate in f32 registers over the query tiles and are
// written once: no atomics, deterministic. p and ds are rounded to bf16
// before their products, as in the TPU kernel. It is K2 (flash_bwd.cu)
// without dq, plus the band.
//
// What bounds it on the H100: four products, 8*H*64 FLOP per (query, key)
// pair a query sees. Non-causal at the cross shape, tensor-core FLOPs bound
// it, and the CUDA cores (exp, ds, the keep-mask hash) set the pace first.
// At the paper's window (100) a key is seen by at most 101 queries against
// 768 bytes of q, k, v, do, dk and dv per key and head: bytes bound it.
// Every per-score multiply and modulo of the hash is hoisted out of the
// loop; wgmma/TMA are later work.
#include "flash_common.cuh"

using namespace flash;

// shared memory: K, V, Q[2], dO[2] tiles (bf16), lse*log2(e)[2], delta[2]
constexpr int DKV_SMEM = 6 * TILE * (int)sizeof(bf16) + 4 * BQ * (int)sizeof(float);

template <bool CAUSAL>
__global__ void __launch_bounds__(NT)
flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                 const int* __restrict__ kv_len, const uint8_t* __restrict__ kv_valid,
                 const int* __restrict__ seed_p, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, int H, int Lq, int Lk, int mbq, int mbk, int window, float rate,
                 float keep_scale, uint32_t thresh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + TILE;
  bf16* sQ = sV + TILE;       // [2][TILE]
  bf16* sdO = sQ + 2 * TILE;  // [2][TILE]
  float* sLse = reinterpret_cast<float*>(sdO + 2 * TILE);  // [2][BQ], log2 domain
  float* sDelta = sLse + 2 * BQ;                            // [2][BQ]

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int ld = H * DH;
  const int k0 = kt * BK;
  const bf16* qb = q + (size_t)b * Lq * ld + h * DH;
  const bf16* dob = dout + (size_t)b * Lq * ld + h * DH;
  const float* lseb = lse + ((size_t)b * H + h) * Lq;
  const float* deltab = delta + ((size_t)b * H + h) * Lq;
  const int len = min(kv_len[b], Lk);
  const bool dropout = rate > 0.f;
  const int seed = dropout ? *seed_p : 0;
  const float scale = 0.125f;  // 1/sqrt(64)
  int qt_lo, qt_hi;
  query_tiles<CAUSAL>(k0, (Lq + BQ - 1) / BQ, window, qt_lo, qt_hi);
  const int n_iter = qt_hi - qt_lo + 1;  // <= 0: no query sees these keys; dk = dv = 0

  auto issue_q = [&](int qt, int buf) {
    const int q0 = qt * BQ;
    load_tile_async(sQ + buf * TILE, qb, q0, Lq, ld, tid);
    load_tile_async(sdO + buf * TILE, dob, q0, Lq, ld, tid);
    cp_async_commit();
    if (tid < BQ) {
      const bool in = q0 + tid < Lq;
      sLse[buf * BQ + tid] = in ? lseb[q0 + tid] * LOG2E : 0.f;
      sDelta[buf * BQ + tid] = in ? deltab[q0 + tid] : 0.f;
    }
  };

  if (n_iter > 0) {
    load_tile_async(sK, k + (size_t)b * Lk * ld + h * DH, k0, Lk, ld, tid);
    load_tile_async(sV, v + (size_t)b * Lk * ld + h * DH, k0, Lk, ld, tid);
    issue_q(qt_lo, 0);  // commits K, V and the first Q/dO tile as one group
  }

  // keys owned by this thread: r = 0 -> k0+warp*16+g, r = 1 -> +8
  const int krow[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  bool kval[2];
  uint32_t col_term[2];  // hash column terms; k tiles lie inside one mask k-block
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    kval[r] = key_valid(kv_valid + (size_t)b * Lk, len, krow[r]);
    col_term[r] = (uint32_t)(krow[r] % mbk) * COL_MUL;
  }

  float dk_acc[8][4], dv_acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  }
  uint32_t kf[4][4], vf[4][4];

  for (int it = 0; it < n_iter; ++it) {
    const int qt = qt_lo + it;
    const int buf = it & 1;
    const int q0 = qt * BQ;
    if (it + 1 < n_iter) {
      issue_q(qt + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
      load_a_frags(kf, sK, warp * 16, lane);
      load_a_frags(vf, sV, warp * 16, lane);
    }
    const bf16* Q = sQ + buf * TILE;
    const bf16* dO = sdO + buf * TILE;
    const float* L2 = sLse + buf * BQ;
    const float* D = sDelta + buf * BQ;

    // s^T = k q^T and dp^T = v do^T: 16 keys x 64 queries (8 tiles of 8)
    float st[8][4], dpt[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      uint32_t bq[4][2], bd[4][2];
      load_bt_frags(bq, Q, j * 8, lane);
      load_bt_frags(bd, dO, j * 8, lane);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        mma16816(st[j], kf[kk], bq[kk]);
        mma16816(dpt[j], vf[kk], bd[kk]);
      }
    }

    const uint32_t mixmul = dropout ? block_mix(seed, b, q0 / mbq, k0 / mbk) : 0u;
    // q tiles of 64 lie inside one mask q-block: row = h*mbq + q0 % mbq + qc
    const uint32_t row_term = (uint32_t)(h * mbq + q0 % mbq + 2 * t) * ROW_MUL;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int qc = j * 8 + 2 * t + (e & 1);
        const bool see = kval[r] && q0 + qc < Lq && in_band<CAUSAL>(q0 + qc, krow[r], window);
        const float p = see ? ex2(st[j][e] * (scale * LOG2E) - L2[qc]) : 0.f;
        float dp = dpt[j][e];
        float p_drop = p;
        if (dropout) {
          const uint32_t x = mixmul ^ col_term[r] ^ (row_term + (uint32_t)(j * 8 + (e & 1)) * ROW_MUL);
          const bool keep = keep_bit(x, thresh);
          p_drop = keep ? p * keep_scale : 0.f;
          dp = keep ? dp * keep_scale : 0.f;
        }
        st[j][e] = p_drop;
        dpt[j][e] = p * (dp - D[qc]) * scale;  // ds
      }
    }

    // dv += p_drop^T do and dk += ds^T q: the [key][query] accumulators of
    // query tiles 2kc, 2kc+1 are the A fragment of the 16-query chunk kc.
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t ap[4] = {pack_f2(st[2 * kc][0], st[2 * kc][1]), pack_f2(st[2 * kc][2], st[2 * kc][3]),
                        pack_f2(st[2 * kc + 1][0], st[2 * kc + 1][1]),
                        pack_f2(st[2 * kc + 1][2], st[2 * kc + 1][3])};
      uint32_t as[4] = {pack_f2(dpt[2 * kc][0], dpt[2 * kc][1]),
                        pack_f2(dpt[2 * kc][2], dpt[2 * kc][3]),
                        pack_f2(dpt[2 * kc + 1][0], dpt[2 * kc + 1][1]),
                        pack_f2(dpt[2 * kc + 1][2], dpt[2 * kc + 1][3])};
      uint32_t bd[8][2], bq[8][2];
      load_b_frags(bd, dO, kc * 16, lane);
      load_b_frags(bq, Q, kc * 16, lane);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        mma16816(dv_acc[n], ap, bd[n]);
        mma16816(dk_acc[n], as, bq[n]);
      }
    }
    __syncthreads();  // every warp is done with this Q/dO buffer before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (krow[r] >= Lk) continue;
    bf16* dkrow = dk + ((size_t)b * Lk + krow[r]) * ld + h * DH;
    bf16* dvrow = dv + ((size_t)b * Lk + krow[r]) * ld + h * DH;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dkrow + n * 8 + 2 * t) =
          __floats2bfloat162_rn(dk_acc[n][2 * r], dk_acc[n][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvrow + n * 8 + 2 * t) =
          __floats2bfloat162_rn(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

extern "C" int flash_dkv_launch(const void* q, const void* k, const void* v, const void* kv_len,
                                const void* kv_valid, const void* seed, const void* dout,
                                const void* lse, const void* delta, void* dk, void* dv, int B, int H,
                                int Lq, int Lk, int mbq, int mbk, int causal, int window, float rate,
                                float keep_scale, unsigned int thresh, void* stream) {
  auto kernel = causal ? &flash_dkv_kernel<true> : &flash_dkv_kernel<false>;
  static bool configured[2] = {false, false};
  if (!configured[causal ? 1 : 0]) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DKV_SMEM);
    if (err != cudaSuccess) return (int)err;
    configured[causal ? 1 : 0] = true;
  }
  dim3 grid((Lk + BK - 1) / BK, H, B);
  kernel<<<grid, NT, DKV_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)kv_len, (const uint8_t*)kv_valid,
      (const int*)seed, (const bf16*)dout, (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv,
      H, Lq, Lk, mbq, mbk, window, rate, keep_scale, thresh);
  return (int)cudaGetLastError();
}
