// L2c: dk and dv of the per-head flash attention backward.
//
// Replaces tools/legacy_flash/flash_attention_bwd.py _dkv_kernel (:150,
// pallas_call :360; windowed query range :161-166), which the JAX backward
// runs after _dq_kernel. Per (b, h), with scale = 1/sqrt(D), p = exp(s *
// scale - lse) on the keys each query sees (0 elsewhere; the key test of
// L2a) and delta = rowsum(do * o) computed by the caller:
//   dp = do v^T,  ds = p * (dp - delta) * scale,  dv = p^T do,  dk = ds^T q
//
// One block of 4 warps per (64-key tile, head, batch row) walks the query
// tiles that can see its keys (query_tiles: none when the tile starts at
// or past kv_len; from the diagonal on, and up to k1 + window, for a causal
// call), with the Q/dO tiles and their lse/delta double-buffered by
// cp.async. Each warp owns 16 keys and works in the transposed frame
// (s^T = k q^T, dp^T = v do^T), reading K and V as mma A fragments from
// shared memory 32 columns at a time, so dk and dv accumulate in f32
// registers over the query tiles and are written once: no atomics,
// deterministic. p and ds are rounded to bf16 before their products (the
// JAX kernel keeps them in f32). The TPU kernel carried dk/dv in VMEM
// across its sequential query-block axis; here that axis is the loop
// inside the block.
//
// What bounds it on the H100: four products, 8*D FLOP per (query, key)
// pair a query sees. At the cross shape tensor-core FLOPs bound it, and
// the CUDA cores (an exp and ds per score) set the pace first. In a
// windowed causal call at W = 100 a key is seen by at most 101 queries:
// bytes bound it. wgmma/TMA are later work.
#include "legacy_flash_common.cuh"

using namespace legacy;
using flash::LOG2E;

// shared memory: K, V, Q[2], dO[2] tiles (bf16), lse*log2(e)[2][BQ], delta[2][BQ]
template <int DP>
constexpr int dkv_smem() {
  return 6 * Tile<DP>::ELEMS * (int)sizeof(bf16) + 4 * BQ * (int)sizeof(float);
}

template <int DP, bool CAUSAL>
__global__ void __launch_bounds__(NT)
lf_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const int* __restrict__ kv_len, const uint8_t* __restrict__ kv_valid, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dk,
              bf16* __restrict__ dv, int H, int Lq, int Lk, int D, int window, float scale) {
  constexpr int TE = Tile<DP>::ELEMS, NB = Tile<DP>::NB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + TE;
  bf16* sQ = sV + TE;         // [2][TE]
  bf16* sdO = sQ + 2 * TE;    // [2][TE]
  float* sLse = reinterpret_cast<float*>(sdO + 2 * TE);  // [2][BQ], log2 domain
  float* sDelta = sLse + 2 * BQ;                         // [2][BQ]

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const size_t bh = (size_t)b * H + h;
  const int k0 = kt * BK;
  const bf16* qb = q + bh * Lq * D;
  const bf16* dob = dout + bh * Lq * D;
  const float* lseb = lse + bh * Lq;
  const float* deltab = delta + bh * Lq;
  const int len = min(kv_len[b], Lk);
  const float scale_log2 = scale * LOG2E;
  int qt_lo, qt_hi;
  query_tiles<CAUSAL>(k0, (Lq + BQ - 1) / BQ, len, window, qt_lo, qt_hi);
  const int n_iter = qt_hi - qt_lo + 1;  // <= 0: no query sees these keys; dk = dv = 0

  auto issue_q = [&](int qt, int buf) {
    const int q0 = qt * BQ;
    load_tile<DP>(sQ + buf * TE, qb, q0, Lq, D, tid);
    load_tile<DP>(sdO + buf * TE, dob, q0, Lq, D, tid);
    flash::cp_async_commit();
    if (tid < BQ) {
      const bool in = q0 + tid < Lq;
      sLse[buf * BQ + tid] = in ? lseb[q0 + tid] * LOG2E : 0.f;
      sDelta[buf * BQ + tid] = in ? deltab[q0 + tid] : 0.f;
    }
  };

  if (n_iter > 0) {
    load_tile<DP>(sK, k + bh * Lk * D, k0, Lk, D, tid);
    load_tile<DP>(sV, v + bh * Lk * D, k0, Lk, D, tid);
    issue_q(qt_lo, 0);  // commits K, V and the first Q/dO tile as one group
  }

  // keys owned by this thread: r = 0 -> k0+warp*16+g, r = 1 -> +8
  const int krow[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const bool kval[2] = {key_ok(kv_valid + (size_t)b * Lk, len, krow[0]),
                        key_ok(kv_valid + (size_t)b * Lk, len, krow[1])};

  float dk_acc[NB][4], dv_acc[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  }

  for (int it = 0; it < n_iter; ++it) {
    const int qt = qt_lo + it;
    const int buf = it & 1;
    const int q0 = qt * BQ;
    if (it + 1 < n_iter) {
      issue_q(qt + 1, buf ^ 1);
      flash::cp_async_wait<1>();
    } else {
      flash::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Q = sQ + buf * TE;
    const bf16* dO = sdO + buf * TE;
    const float* L2 = sLse + buf * BQ;
    const float* Dl = sDelta + buf * BQ;

    // s^T = k q^T and dp^T = v do^T: 16 keys x 64 queries (8 tiles of 8),
    // 32 head columns at a time
    float st[8][4], dpt[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
    }
#pragma unroll
    for (int c2 = 0; c2 < DP / 32; ++c2) {
      uint32_t ka[2][4], va[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        a_frag<DP>(ka[i], sK, warp * 16, 2 * c2 + i, lane);
        a_frag<DP>(va[i], sV, warp * 16, 2 * c2 + i, lane);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t bq[2][2], bd[2][2];
        bt_frags<DP>(bq, Q, j * 8, c2 * 32, lane);
        bt_frags<DP>(bd, dO, j * 8, c2 * 32, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          flash::mma16816(st[j], ka[i], bq[i]);
          flash::mma16816(dpt[j], va[i], bd[i]);
        }
      }
    }

#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int qc = j * 8 + 2 * t + (e & 1);
        const bool see = kval[r] && q0 + qc < Lq && in_band<CAUSAL>(q0 + qc, krow[r], window);
        const float p = see ? flash::ex2(st[j][e] * scale_log2 - L2[qc]) : 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - Dl[qc]) * scale;  // ds
      }
    }

    // dv += p^T do and dk += ds^T q: the [key][query] accumulators of query
    // tiles 2kc, 2kc+1 are the A fragment of the 16-query chunk kc.
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const uint32_t ap[4] = {flash::pack_f2(st[2 * kc][0], st[2 * kc][1]),
                              flash::pack_f2(st[2 * kc][2], st[2 * kc][3]),
                              flash::pack_f2(st[2 * kc + 1][0], st[2 * kc + 1][1]),
                              flash::pack_f2(st[2 * kc + 1][2], st[2 * kc + 1][3])};
      const uint32_t as[4] = {flash::pack_f2(dpt[2 * kc][0], dpt[2 * kc][1]),
                              flash::pack_f2(dpt[2 * kc][2], dpt[2 * kc][3]),
                              flash::pack_f2(dpt[2 * kc + 1][0], dpt[2 * kc + 1][1]),
                              flash::pack_f2(dpt[2 * kc + 1][2], dpt[2 * kc + 1][3])};
#pragma unroll
      for (int n = 0; n < NB; n += 2) {
        uint32_t bd[2][2], bq[2][2];
        b_frags<DP>(bd, dO, kc * 16, n, lane);
        b_frags<DP>(bq, Q, kc * 16, n, lane);
        flash::mma16816(dv_acc[n], ap, bd[0]);
        flash::mma16816(dv_acc[n + 1], ap, bd[1]);
        flash::mma16816(dk_acc[n], as, bq[0]);
        flash::mma16816(dk_acc[n + 1], as, bq[1]);
      }
    }
    __syncthreads();  // every warp is done with this Q/dO buffer before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (krow[r] >= Lk) continue;
    bf16* dkrow = dk + (bh * Lk + krow[r]) * D;
    bf16* dvrow = dv + (bh * Lk + krow[r]) * D;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      if (n * 8 < D) {
        *reinterpret_cast<__nv_bfloat162*>(dkrow + n * 8 + 2 * t) =
            __floats2bfloat162_rn(dk_acc[n][2 * r], dk_acc[n][2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dvrow + n * 8 + 2 * t) =
            __floats2bfloat162_rn(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
      }
    }
  }
}

template <int DP>
static int dkv_dispatch(const bf16* q, const bf16* k, const bf16* v, const int* kv_len, const uint8_t* kv_valid,
                        const bf16* dout, const float* lse, const float* delta, bf16* dk, bf16* dv, int B, int H,
                        int Lq, int Lk, int D, bool causal, int window, float scale, void* stream) {
  const dim3 grid((Lk + BK - 1) / BK, H, B);
  auto kernel = causal ? &lf_dkv_kernel<DP, true> : &lf_dkv_kernel<DP, false>;
  return launch(kernel, grid, dkv_smem<DP>(), stream, q, k, v, kv_len, kv_valid, dout, lse, delta, dk, dv, H, Lq,
                Lk, D, window, scale);
}

// D % 8 == 0, D <= 128.
extern "C" int lf_dkv_launch(const void* q, const void* k, const void* v, const void* kv_len, const void* kv_valid,
                             const void* dout, const void* lse, const void* delta, void* dk, void* dv, int B, int H,
                             int Lq, int Lk, int D, int causal, int window, float scale, void* stream) {
  if (D <= 0 || D > 128 || D % 8) return (int)cudaErrorInvalidValue;
  auto run = D <= 64 ? &dkv_dispatch<64> : &dkv_dispatch<128>;
  return run((const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)kv_len, (const uint8_t*)kv_valid,
             (const bf16*)dout, (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, B, H, Lq, Lk, D,
             causal != 0, window, scale, stream);
}
