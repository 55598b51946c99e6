// L1 / L2a: per-head flash attention forward, without (L1) or with (L2a)
// the per-position key mask and the saved lse.
//
// Replaces tools/legacy_flash/flash_attention.py _kernel (L1, pallas_call
// :169) and tools/legacy_flash/flash_attention_bwd.py _fwd_kernel (L2a,
// pallas_call :250). Per (b, h), with scale = 1/sqrt(D):
//   o   = softmax(q k^T * scale + mask) v
//   lse = m + log(sum exp)  (L2a only; f32 [B, H, Lq])
// where query q sees key k when k < kv_len[b], (L2a) kv_valid[b, k], and for
// a causal call k <= q and (window > 0) k >= q - window. A query that sees
// no key gets o = 0 and lse = 0, whatever key tiles ran (the JAX kernel
// averages v over the blocks it visited when one of them held no key for
// the row; its comment intends 0).
//
// One block of 4 warps per (64-query tile, head, batch row); each warp owns
// 16 queries and walks the 64-key tiles with an online softmax in f32, kept
// in the log2 domain (one ex2 per score). Both products run on the tensor
// cores as bf16 mma.sync m16n8k16 with f32 accumulation, fed by ldmatrix;
// p is rounded to bf16 before the PV product (the JAX kernel keeps it in
// f32). The score tile never leaves registers: its accumulator layout is
// the A operand of the PV product. K/V tiles are double-buffered with
// cp.async. The block walks only the key tiles below kv_len and, for a
// causal call, those of its band (key_tiles): the JAX kernel visited every
// block below the diagonal (or of its window ladder) and masked per score;
// the per-score key test here makes both give the same o and lse.
//
// What bounds it on the H100: the two products are 4*D FLOP per (query,
// key) pair a query sees against 2*D*2 bytes of k and v per key, read once
// per (b, h): at the cross shape (1268 queries a key) ~1268 FLOP/byte, far
// above the ~295 balance point, so tensor-core FLOPs bound it; the CUDA
// cores (an exp and the online-softmax update per score) set the pace
// first. In a windowed causal call at W = 100 a query sees at most 101
// keys against ~4*D*2 bytes of q, k, v and o per query: bytes bound it,
// and launch latency and the 2-3 key tiles each query tile walks set its
// time. wgmma/TMA and warp specialisation are later work.
#include "legacy_flash_common.cuh"

using namespace legacy;
using flash::LN2;
using flash::NEG_INF;

// shared memory: Q, K[2], V[2] tiles (bf16), then the key test of the two K tiles
template <int DP>
constexpr int fwd_smem() {
  return 5 * Tile<DP>::ELEMS * (int)sizeof(bf16) + 2 * BK;
}

template <int DP, bool CAUSAL, bool LSE>
__device__ __forceinline__ void fwd_body(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                         const bf16* __restrict__ v, const int* __restrict__ kv_len,
                                         const uint8_t* __restrict__ kv_valid, bf16* __restrict__ o,
                                         float* __restrict__ lse, int H, int Lq, int Lk, int D, int window,
                                         float scale_log2) {
  constexpr int TE = Tile<DP>::ELEMS, KC = Tile<DP>::KC, NB = Tile<DP>::NB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + TE;      // [2][TE]
  bf16* sV = sK + 2 * TE;  // [2][TE]
  uint8_t* sOk = reinterpret_cast<uint8_t*>(sV + 2 * TE);  // [2][BK]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const size_t bh = (size_t)b * H + h;
  const int q0 = qt * BQ;
  const bf16* kb = k + bh * Lk * D;
  const bf16* vb = v + bh * Lk * D;
  const uint8_t* valid_b = kv_valid == nullptr ? nullptr : kv_valid + (size_t)b * Lk;
  const int len = min(kv_len[b], Lk);
  int kt_lo, kt_hi;
  key_tiles<CAUSAL>(q0, len, window, kt_lo, kt_hi);
  const int n_iter = kt_hi - kt_lo + 1;  // <= 0: no key to see; o = 0, lse = 0

  auto issue_kv = [&](int kt, int buf) {
    const int k0 = kt * BK;
    load_tile<DP>(sK + buf * TE, kb, k0, Lk, D, tid);
    load_tile<DP>(sV + buf * TE, vb, k0, Lk, D, tid);
    flash::cp_async_commit();
    if (tid < BK) sOk[buf * BK + tid] = key_ok(valid_b, len, k0 + tid) ? 1 : 0;
  };

  if (n_iter > 0) {
    load_tile<DP>(sQ, q + bh * Lq * D, q0, Lq, D, tid);
    issue_kv(kt_lo, 0);  // commits Q and the first K/V tile as one group
  }

  // rows owned by this thread: r = 0 -> query q0+warp*16+g, r = 1 -> +8
  const int qrow[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float m_r[2] = {NEG_INF, NEG_INF};  // running max, log2 domain; NEG_INF until a key is seen
  float l_r[2] = {0.f, 0.f};
  float acc[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  uint32_t qf[KC][4];

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
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) a_frag<DP>(qf[kk], sQ, warp * 16, kk, lane);
    }
    const bf16* K = sK + buf * TE;
    const bf16* V = sV + buf * TE;
    const uint8_t* ok = sOk + buf * BK;

    // s = q k^T for 16 queries x 64 keys (8 tiles of 8 keys)
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int c2 = 0; c2 < DP / 32; ++c2) {
        uint32_t bfr[2][2];
        bt_frags<DP>(bfr, K, j * 8, c2 * 32, lane);
        flash::mma16816(s[j], qf[2 * c2], bfr[0]);
        flash::mma16816(s[j], qf[2 * c2 + 1], bfr[1]);
      }
    }

    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = j * 8 + 2 * t + (e & 1);
        const bool see = ok[kc] && in_band<CAUSAL>(qrow[e >> 1], k0 + kc, window);
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
        const float p = flash::ex2(s[j][e] - mx[e >> 1]);
        s[j][e] = p;
        rs[e >> 1] += p;
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      corr[r] = flash::ex2(m_r[r] - mx[r]);
      l_r[r] = corr[r] * l_r[r] + rs[r];
      m_r[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
    // acc += p v: the score accumulators of key tiles 2kc, 2kc+1 are the A
    // fragment of the 16-key chunk kc.
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const uint32_t a[4] = {flash::pack_f2(s[2 * kc][0], s[2 * kc][1]), flash::pack_f2(s[2 * kc][2], s[2 * kc][3]),
                             flash::pack_f2(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                             flash::pack_f2(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int n = 0; n < NB; n += 2) {
        uint32_t bfr[2][2];
        b_frags<DP>(bfr, V, kc * 16, n, lane);
        flash::mma16816(acc[n], a, bfr[0]);
        flash::mma16816(acc[n + 1], a, bfr[1]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qrow[r] >= Lq) continue;
    const bool seen = m_r[r] > NEG_INF;  // a row that saw no key keeps o = 0, lse = 0
    const float inv = seen ? 1.f / l_r[r] : 0.f;
    bf16* orow = o + (bh * Lq + qrow[r]) * D;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      if (n * 8 < D) {
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
            __floats2bfloat162_rn(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
      }
    }
    if (LSE && t == 0) lse[bh * Lq + qrow[r]] = seen ? m_r[r] * LN2 + logf(l_r[r]) : 0.f;
  }
}

// L1: kv_len and the causal band only.
template <int DP, bool CAUSAL>
__global__ void __launch_bounds__(NT)
lf_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const int* __restrict__ kv_len, bf16* __restrict__ o, int H, int Lq, int Lk, int D, int window,
              float scale_log2) {
  fwd_body<DP, CAUSAL, false>(q, k, v, kv_len, nullptr, o, nullptr, H, Lq, Lk, D, window, scale_log2);
}

// L2a: kv_valid as well, and lse.
template <int DP, bool CAUSAL>
__global__ void __launch_bounds__(NT)
lf_fwd_lse_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                  const int* __restrict__ kv_len, const uint8_t* __restrict__ kv_valid, bf16* __restrict__ o,
                  float* __restrict__ lse, int H, int Lq, int Lk, int D, int window, float scale_log2) {
  fwd_body<DP, CAUSAL, true>(q, k, v, kv_len, kv_valid, o, lse, H, Lq, Lk, D, window, scale_log2);
}

template <int DP>
static int fwd_dispatch(const bf16* q, const bf16* k, const bf16* v, const int* kv_len, const uint8_t* kv_valid,
                        bf16* o, float* lse, int B, int H, int Lq, int Lk, int D, bool causal, int window,
                        bool with_lse, float scale_log2, void* stream) {
  const dim3 grid((Lq + BQ - 1) / BQ, H, B);
  if (with_lse) {
    auto kernel = causal ? &lf_fwd_lse_kernel<DP, true> : &lf_fwd_lse_kernel<DP, false>;
    return launch(kernel, grid, fwd_smem<DP>(), stream, q, k, v, kv_len, kv_valid, o, lse, H, Lq, Lk, D, window,
                  scale_log2);
  }
  auto kernel = causal ? &lf_fwd_kernel<DP, true> : &lf_fwd_kernel<DP, false>;
  return launch(kernel, grid, fwd_smem<DP>(), stream, q, k, v, kv_len, o, H, Lq, Lk, D, window, scale_log2);
}

// with_lse = 0: L1 (kv_valid and lse are ignored); 1: L2a. D % 8 == 0, D <= 128.
extern "C" int lf_fwd_launch(const void* q, const void* k, const void* v, const void* kv_len, const void* kv_valid,
                             void* o, void* lse, int B, int H, int Lq, int Lk, int D, int causal, int window,
                             int with_lse, float scale, void* stream) {
  if (D <= 0 || D > 128 || D % 8 || (with_lse && (kv_valid == nullptr || lse == nullptr)))
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = scale * flash::LOG2E;
  auto run = D <= 64 ? &fwd_dispatch<64> : &fwd_dispatch<128>;
  return run((const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)kv_len,
             with_lse ? (const uint8_t*)kv_valid : nullptr, (bf16*)o, (float*)lse, B, H, Lq, Lk, D, causal != 0,
             window, with_lse != 0, scale_log2, stream);
}
