// L2b: dq of the per-head flash attention backward.
//
// Replaces tools/legacy_flash/flash_attention_bwd.py _dq_kernel (:109,
// pallas_call :328), which the JAX backward runs before _dkv_kernel. Per
// (b, h), with scale = 1/sqrt(D), p = exp(s * scale - lse) on the keys the
// query sees (0 elsewhere; the key test of L2a) and delta = rowsum(do * o)
// computed by the caller:
//   dp = do v^T,  ds = p * (dp - delta) * scale,  dq = ds k
//
// One block of 4 warps per (64-query tile, head, batch row); each warp owns
// 16 queries. The Q and dO tiles stay in shared memory and are read as mma
// A fragments 32 columns at a time, which keeps a 128-wide head within the
// register file; the block walks the key tiles below kv_len and in its
// causal band (key_tiles), with the K/V tiles double-buffered by cp.async.
// s = q k^T and dp = do v^T are bf16 mma.sync products with f32
// accumulation; ds is rounded to bf16 (the JAX kernel keeps it in f32) and
// its accumulator layout is the A operand of dq += ds k. dq accumulates in
// f32 registers over the band and is written once: no atomics, so the
// result is deterministic. The TPU kernel carried dq in VMEM across its
// sequential key-block axis; here that axis is the loop inside the block.
//
// What bounds it on the H100: three products, 6*D FLOP per (query, key)
// pair a query sees. At the cross shape that is far above the ~295
// FLOP/byte balance point (tensor-core FLOPs bound it, the CUDA cores set
// the pace first: an exp and the ds arithmetic per score). In a windowed
// causal call at W = 100 bytes bound it. wgmma/TMA are later work.
#include "legacy_flash_common.cuh"

using namespace legacy;
using flash::LOG2E;

// shared memory: Q, dO, K[2], V[2] tiles (bf16), then the key test of the two K tiles
template <int DP>
constexpr int dq_smem() {
  return 6 * Tile<DP>::ELEMS * (int)sizeof(bf16) + 2 * BK;
}

template <int DP, bool CAUSAL>
__global__ void __launch_bounds__(NT)
lf_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
             const int* __restrict__ kv_len, const uint8_t* __restrict__ kv_valid, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dq, int H, int Lq,
             int Lk, int D, int window, float scale) {
  constexpr int TE = Tile<DP>::ELEMS, NB = Tile<DP>::NB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + TE;
  bf16* sK = sdO + TE;     // [2][TE]
  bf16* sV = sK + 2 * TE;  // [2][TE]
  uint8_t* sOk = reinterpret_cast<uint8_t*>(sV + 2 * TE);  // [2][BK]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const size_t bh = (size_t)b * H + h;
  const int q0 = qt * BQ;
  const bf16* kb = k + bh * Lk * D;
  const bf16* vb = v + bh * Lk * D;
  const uint8_t* valid_b = kv_valid + (size_t)b * Lk;
  const int len = min(kv_len[b], Lk);
  const float scale_log2 = scale * LOG2E;
  int kt_lo, kt_hi;
  key_tiles<CAUSAL>(q0, len, window, kt_lo, kt_hi);
  const int n_iter = kt_hi - kt_lo + 1;  // <= 0: no key to see; dq = 0

  auto issue_kv = [&](int kt, int buf) {
    const int k0 = kt * BK;
    load_tile<DP>(sK + buf * TE, kb, k0, Lk, D, tid);
    load_tile<DP>(sV + buf * TE, vb, k0, Lk, D, tid);
    flash::cp_async_commit();
    if (tid < BK) sOk[buf * BK + tid] = key_ok(valid_b, len, k0 + tid) ? 1 : 0;
  };

  if (n_iter > 0) {
    load_tile<DP>(sQ, q + bh * Lq * D, q0, Lq, D, tid);
    load_tile<DP>(sdO, dout + bh * Lq * D, q0, Lq, D, tid);
    issue_kv(kt_lo, 0);  // commits Q, dO and the first K/V tile as one group
  }

  // rows owned by this thread: r = 0 -> query q0+warp*16+g, r = 1 -> +8
  const int qrow[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float lse2[2], dlt[2];  // lse in the log2 domain, delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = qrow[r] < Lq;
    lse2[r] = in ? lse[bh * Lq + qrow[r]] * LOG2E : 0.f;
    dlt[r] = in ? delta[bh * Lq + qrow[r]] : 0.f;
  }
  float acc[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    const int kt = kt_lo + it;
    const int buf = it & 1;
    const int k0 = kt * BK;
    if (it + 1 < n_iter) {
      issue_kv(kt + 1, buf ^ 1);
      flash::cp_async_wait<1>();
    } else {
      flash::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* K = sK + buf * TE;
    const bf16* V = sV + buf * TE;
    const uint8_t* ok = sOk + buf * BK;

    // s = q k^T and dp = do v^T for 16 queries x 64 keys (8 tiles of 8 keys),
    // 32 head columns at a time
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll
    for (int c2 = 0; c2 < DP / 32; ++c2) {
      uint32_t qa[2][4], da[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        a_frag<DP>(qa[i], sQ, warp * 16, 2 * c2 + i, lane);
        a_frag<DP>(da[i], sdO, warp * 16, 2 * c2 + i, lane);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t bk[2][2], bv[2][2];
        bt_frags<DP>(bk, K, j * 8, c2 * 32, lane);
        bt_frags<DP>(bv, V, j * 8, c2 * 32, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          flash::mma16816(s[j], qa[i], bk[i]);
          flash::mma16816(dp[j], da[i], bv[i]);
        }
      }
    }

#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kc = j * 8 + 2 * t + (e & 1);
        const bool see = ok[kc] && qrow[r] < Lq && in_band<CAUSAL>(qrow[r], k0 + kc, window);
        const float p = see ? flash::ex2(s[j][e] * scale_log2 - lse2[r]) : 0.f;
        s[j][e] = p * (dp[j][e] - dlt[r]) * scale;  // ds
      }
    }

    // dq += ds k: the ds accumulators of key tiles 2kc, 2kc+1 are the A
    // fragment of the 16-key chunk kc; k rows are the B operand.
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const uint32_t a[4] = {flash::pack_f2(s[2 * kc][0], s[2 * kc][1]), flash::pack_f2(s[2 * kc][2], s[2 * kc][3]),
                             flash::pack_f2(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                             flash::pack_f2(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int n = 0; n < NB; n += 2) {
        uint32_t bfr[2][2];
        b_frags<DP>(bfr, K, kc * 16, n, lane);
        flash::mma16816(acc[n], a, bfr[0]);
        flash::mma16816(acc[n + 1], a, bfr[1]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qrow[r] >= Lq) continue;
    bf16* drow = dq + (bh * Lq + qrow[r]) * D;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      if (n * 8 < D) {
        *reinterpret_cast<__nv_bfloat162*>(drow + n * 8 + 2 * t) =
            __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
      }
    }
  }
}

template <int DP>
static int dq_dispatch(const bf16* q, const bf16* k, const bf16* v, const int* kv_len, const uint8_t* kv_valid,
                       const bf16* dout, const float* lse, const float* delta, bf16* dq, int B, int H, int Lq, int Lk,
                       int D, bool causal, int window, float scale, void* stream) {
  const dim3 grid((Lq + BQ - 1) / BQ, H, B);
  auto kernel = causal ? &lf_dq_kernel<DP, true> : &lf_dq_kernel<DP, false>;
  return launch(kernel, grid, dq_smem<DP>(), stream, q, k, v, kv_len, kv_valid, dout, lse, delta, dq, H, Lq, Lk, D,
                window, scale);
}

// D % 8 == 0, D <= 128.
extern "C" int lf_dq_launch(const void* q, const void* k, const void* v, const void* kv_len, const void* kv_valid,
                            const void* dout, const void* lse, const void* delta, void* dq, int B, int H, int Lq,
                            int Lk, int D, int causal, int window, float scale, void* stream) {
  if (D <= 0 || D > 128 || D % 8) return (int)cudaErrorInvalidValue;
  auto run = D <= 64 ? &dq_dispatch<64> : &dq_dispatch<128>;
  return run((const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)kv_len, (const uint8_t*)kv_valid,
             (const bf16*)dout, (const float*)lse, (const float*)delta, (bf16*)dq, B, H, Lq, Lk, D, causal != 0,
             window, scale, stream);
}
