// K2: head-packed flash attention backward (dq, dk, dv in one pass).
//
// Replaces omr_a2s_multimodal_transformer_tpu/ops/flash_packed.py
// _dqkv_kernel (the merged backward of the non-causal path). Per head h,
// with p = exp(s - lse) on unmasked keys (0 elsewhere), M the dropout
// keep-mask regenerated from the same hash as the forward and
// delta = rowsum(do * o) per (b, h, q) computed by the caller:
//   dp = (do v^T) * M / (1 - rate),  ds = p * (dp - delta) / 8
//   dv = (p * M / (1 - rate))^T do,  dk = ds^T q,  dq = ds k
//
// One block of 4 warps per (64-key tile, head, batch row) walks every query
// tile, with the Q/dO tiles double-buffered by cp.async. Each warp owns 16
// keys and works in the transposed frame (s^T = k q^T, dp^T = v do^T), so
// dk and dv accumulate in registers over all query tiles and are written
// once. ds (rounded to bf16, as in the TPU kernel) goes through shared
// memory for dq = ds k, whose 64x64 partial per (key tile, query tile) is
// added into a float32 [B, Lq, H*64] buffer with 16-byte vector atomicAdd
// (sm_90). The order of those adds changes from run to run, so dq is not
// bitwise deterministic; its error is that of an f32 sum over ceil(Lk/64)
// partials.
//
// What bounds it on the H100: five products, 10*B*H*Lq*Lk*64 FLOP, about
// 2.5x the forward, so tensor-core FLOPs bound it. The CUDA cores come
// first here too (exp, the keep-mask hash, ds), then the dq atomics
// (B*H*Lq*Lk/16 floats). Every per-score multiply and modulo of the hash is
// hoisted out of the loop; wgmma/TMA and a dq pass without atomics are
// later work.
#include "flash_common.cuh"

using namespace flash;

// shared memory: K, dS^T, Q[2], dO[2] tiles (bf16), lse*log2(e)[2], delta[2]
constexpr int BWD_SMEM = 6 * TILE * (int)sizeof(bf16) + 4 * BQ * (int)sizeof(float);

__global__ void __launch_bounds__(NT)
flash_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                 const int* __restrict__ kv_len, const uint8_t* __restrict__ kv_valid,
                 const int* __restrict__ seed_p, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dq_acc, bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                 int Lq, int Lk, int mbq, int mbk, float rate, float keep_scale, uint32_t thresh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdS = sK + TILE;     // ds^T: [key][query]; holds V until its fragments are loaded
  bf16* sQ = sdS + TILE;     // [2][TILE]
  bf16* sdO = sQ + 2 * TILE; // [2][TILE]
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
  const int nqt = (Lq + BQ - 1) / BQ;

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

  load_tile_async(sK, k + (size_t)b * Lk * ld + h * DH, k0, Lk, ld, tid);
  load_tile_async(sdS, v + (size_t)b * Lk * ld + h * DH, k0, Lk, ld, tid);
  issue_q(0, 0);  // commits K, V and the first Q/dO tile as one group

  // keys owned by this thread: r = 0 -> k0+warp*16+g, r = 1 -> +8
  const int krow[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  bool kval[2];
  uint32_t col_term[2];  // hash column terms; k tiles lie inside one mask k-block
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    kval[r] = krow[r] < len && kv_valid[(size_t)b * Lk + krow[r]];
    col_term[r] = (uint32_t)(krow[r] % mbk) * COL_MUL;
  }

  float dk_acc[8][4], dv_acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  }
  uint32_t kf[4][4], vf[4][4];

  for (int qt = 0; qt < nqt; ++qt) {
    const int buf = qt & 1;
    const int q0 = qt * BQ;
    if (qt + 1 < nqt) {
      issue_q(qt + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (qt == 0) {
      load_a_frags(kf, sK, warp * 16, lane);
      load_a_frags(vf, sdS, warp * 16, lane);
      __syncthreads();  // V is in registers; sdS is free for ds
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
        const float p = (kval[r] && q0 + qc < Lq) ? ex2(st[j][e] * (scale * LOG2E) - L2[qc]) : 0.f;
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
    const int key0 = warp * 16 + g;
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
      // ds^T (bf16) to shared memory for the dq product
      *reinterpret_cast<uint32_t*>(sdS + key0 * SROW + kc * 16 + 2 * t) = as[0];
      *reinterpret_cast<uint32_t*>(sdS + (key0 + 8) * SROW + kc * 16 + 2 * t) = as[1];
      *reinterpret_cast<uint32_t*>(sdS + key0 * SROW + kc * 16 + 8 + 2 * t) = as[2];
      *reinterpret_cast<uint32_t*>(sdS + (key0 + 8) * SROW + kc * 16 + 8 + 2 * t) = as[3];
    }
    __syncthreads();

    // dq[64 queries x 64] += ds[query][key] k[key][:]; warp w owns queries
    // w*16..w*16+15. A (query x key) is ds^T read transposed, B (key x d) is k.
    float dq[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
    const bf16* pa = sdS + ((lane & 7) + (lane >> 4) * 8) * SROW + warp * 16 + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t a[4], bk[8][2];
      ldsm_x4_t(a, pa + kc * 16 * SROW);
      load_b_frags(bk, sK, kc * 16, lane);
#pragma unroll
      for (int n = 0; n < 8; ++n) mma16816(dq[n], a, bk[n]);
    }
    // 16-byte atomics: lanes t and t^1 trade halves so that, for tile n,
    // the lane with t % 2 == n % 2 adds four consecutive columns.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qg = q0 + warp * 16 + g + 8 * r;
      float* drow = dq_acc + ((size_t)b * Lq + qg) * ld + h * DH;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float lo = dq[n][2 * r], hi = dq[n][2 * r + 1];
        const float plo = __shfl_xor_sync(0xffffffffu, lo, 1);
        const float phi = __shfl_xor_sync(0xffffffffu, hi, 1);
        if (qg < Lq && (t & 1) == (n & 1)) {
          const float4 val = (t & 1) ? make_float4(plo, phi, lo, hi) : make_float4(lo, hi, plo, phi);
          atomicAdd(reinterpret_cast<float4*>(drow + n * 8 + 2 * (t & ~1)), val);
        }
      }
    }
    __syncthreads();  // every warp is done with sdS and this Q/dO buffer
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

extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v, const void* kv_len,
                                const void* kv_valid, const void* seed, const void* dout,
                                const void* lse, const void* delta, void* dq_acc, void* dk, void* dv,
                                int B, int H, int Lq, int Lk, int mbq, int mbk, float rate,
                                float keep_scale, unsigned int thresh, void* stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(flash_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((Lk + BK - 1) / BK, H, B);
  flash_bwd_kernel<<<grid, NT, BWD_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)kv_len, (const uint8_t*)kv_valid,
      (const int*)seed, (const bf16*)dout, (const float*)lse, (const float*)delta, (float*)dq_acc,
      (bf16*)dk, (bf16*)dv, H, Lq, Lk, mbq, mbk, rate, keep_scale, thresh);
  return (int)cudaGetLastError();
}
