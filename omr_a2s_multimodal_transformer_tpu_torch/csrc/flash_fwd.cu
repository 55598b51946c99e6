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
// cores, set its floor. The design:
// - a block of four warpgroups: a producer (one warp issues TMA loads of
//   128-byte-swizzled 64 x 64 tiles from 3-D tensor maps over [B, L, H*64],
//   head h a column offset, rows past L zero-filled, into a 4-stage K/V
//   ring guarded by mbarriers, and writes each key tile's mask as an
//   additive 0 / -1e30 bias and, with dropout, the first step of the hash
//   folded into its column terms, fold16), and three consumer warpgroups
//   of 64 queries each that share the K/V tiles (a third of the L2 traffic
//   of 64-query blocks); setmaxnreg moves the producer's registers to them.
//   Three consumers (12 warps an SM) rather than two: while one runs its
//   softmax and hash on the CUDA cores, the others' products and waits
//   fill the SM (three were faster than two at dropout 0.1 on the H100);
// - both products on wgmma: s = q k^T from shared memory (K-major q and k),
//   o += p v with p from registers (bf16, the accumulator layout re-used as
//   the A fragment) and v read MN-major, so no transpose copy;
// - o += p v of tile i and s = q k^T of tile i + 1 are in flight together;
//   every product is retired inside its loop iteration (a product left in
//   flight across the loop's back edge made ptxas serialize the wgmma
//   pipeline);
// - no wave tail: one block fills an SM, so the key tiles are split into a
//   few chunks (chosen by the wrapper for the SM count, fwd_splits) whose
//   partial (o, lse) a merge kernel combines by lse.
// The accumulator layout gives each thread rows 16w + g and + 8 and column
// pairs 8j + 2t, the layout of the mma.sync kernels, so the hoisted hash
// terms are the same and the keep-mask is the same bit for bit.
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
#include "flash_common.cuh"
#include "hopper_common.cuh"

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

namespace k1 {

constexpr int STAGES = 4;
constexpr int NCONS = 3;            // consumer warpgroups of 64 queries
constexpr int THREADS = 128 * (NCONS + 1);
constexpr int ROWS = 64 * NCONS;    // queries per block, 64 per consumer warpgroup
constexpr int TILE_BYTES = 64 * 64 * 2;

struct Smem {
  bf16 q[NCONS][64 * 64];  // each 1024-byte aligned (the struct is placed at a 1024-byte boundary)
  bf16 k[STAGES][64 * 64];
  bf16 v[STAGES][64 * 64];
  float bias[STAGES][64];  // 0 for a key to see, -1e30 for a masked one
  uint32_t colx[STAGES][64];  // fold16 of each key's hash column term (dropout only)
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
  uint64_t qbar;
};

constexpr int SMEM_BYTES = (int)sizeof(Smem) + 1024;  // + room to align the base

__device__ __forceinline__ Smem& smem() {
  extern __shared__ unsigned char smem_raw[];
  return *reinterpret_cast<Smem*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
}

}  // namespace k1

// grid (ceil(Lq / 128), H, B * n_split); block z = b * n_split + split walks
// key tiles [split * per, min(n_tiles, (split + 1) * per)). n_split == 1
// writes o (bf16) and lse; otherwise the normalized partial o (f32, [n_split,
// B, Lq, H*64]) and its lse ([n_split, B, H, Lq]) for the merge kernel.
__global__ void __launch_bounds__(k1::THREADS, 1)
flash_fwd_tma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const int* __restrict__ kv_len,
                     const uint8_t* __restrict__ kv_valid, const int* __restrict__ seed_p, bf16* __restrict__ o,
                     float* __restrict__ lse, float* __restrict__ o_part, float* __restrict__ lse_part, int B, int H,
                     int Lq, int Lk, int mbq, int mbk, int n_split, int per, float rate, float keep_scale,
                     uint32_t thresh) {
  using namespace hopper;
  k1::Smem& sm = k1::smem();
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z / n_split, split = blockIdx.z % n_split;
  const int n_tiles = (Lk + BK - 1) / BK;
  const int kt_lo = split * per;
  const int n_iter = min(n_tiles, kt_lo + per) - kt_lo;  // >= 1 (the wrapper's split)
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < k1::STAGES; ++s) {
      mbar_init(&sm.full[s], 32);    // the producer warp's lanes (lane 0 also expects the TMA bytes)
      mbar_init(&sm.empty[s], 128 * k1::NCONS);  // every consumer thread
    }
    mbar_init(&sm.qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one warp; the warpgroup gives up its registers
    reg_dealloc<24>();
    const int lane = threadIdx.x;
    if (lane < 32) {
      const bool dropout = rate > 0.f;
      const int len = min(kv_len[b], Lk);
      const uint8_t* validb = kv_valid + (size_t)b * Lk;
      if (lane == 0) {
        mbar_arrive_expect_tx(&sm.qbar, k1::NCONS * k1::TILE_BYTES);
        for (int c = 0; c < k1::NCONS; ++c) tma_load_3d(sm.q[c], &tq, &sm.qbar, h * DH, qt * k1::ROWS + 64 * c, b);
      }
      // each lane tests keys lane and lane + 32 of a tile; the next tile's
      // test is loaded before the wait for its stage
      auto key_test = [&](int k0, int i) { return k0 + i < len && validb[k0 + i] != 0; };
      bool ok0 = key_test(kt_lo * BK, lane), ok1 = key_test(kt_lo * BK, lane + 32);
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % k1::STAGES;
        const int k0 = (kt_lo + it) * BK;
        const bool cur0 = ok0, cur1 = ok1;
        if (it + 1 < n_iter) {
          ok0 = key_test(k0 + BK, lane);
          ok1 = key_test(k0 + BK, lane + 32);
        }
        mbar_wait(&sm.empty[s], ((it / k1::STAGES) & 1) ^ 1);
        sm.bias[s][lane] = cur0 ? 0.f : NEG_INF;
        sm.bias[s][lane + 32] = cur1 ? 0.f : NEG_INF;
        if (dropout) {
          const uint32_t c0 = (uint32_t)(k0 % mbk + lane);  // a key tile lies inside one mask k-block
          sm.colx[s][lane] = fold16(c0 * COL_MUL);
          sm.colx[s][lane + 32] = fold16((c0 + 32) * COL_MUL);
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&sm.full[s], 2 * k1::TILE_BYTES);
          tma_load_3d(sm.k[s], &tk, &sm.full[s], h * DH, k0, b);
          tma_load_3d(sm.v[s], &tv, &sm.full[s], h * DH, k0, b);
        } else {
          mbar_arrive(&sm.full[s]);
        }
      }
    }
  } else {
    // ---- consumers: 64 queries each
    reg_alloc<160>();
    const int c = wg - 1;
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int q0 = qt * k1::ROWS + c * 64;
    const int qrow0 = q0 + warp * 16 + g;  // rows qrow0 and qrow0 + 8
    const bool dropout = rate > 0.f;
    const int seed = dropout ? *seed_p : 0;
    const float scale_log2 = 0.125f * LOG2E;  // 1/sqrt(64), in the log2 domain
    // hash row terms; a 64-query tile lies inside one mask q-block (mbq % 64 == 0)
    const uint32_t row_term[2] = {(uint32_t)(h * mbq + qrow0 % mbq) * ROW_MUL,
                                  (uint32_t)(h * mbq + (qrow0 + 8) % mbq) * ROW_MUL};
    float acc[32], s[32];
    uint32_t pa[16];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    float m_r[2] = {NEG_INF, NEG_INF};  // running max, log2 domain
    float l_r[2] = {0.f, 0.f};

    // s = q k^T (64 x 64) of the tile in stage st
    const uint64_t dq = sw128_desc(sm.q[c]);
    auto issue_s = [&](int st) {
      const uint64_t dk = sw128_desc(sm.k[st]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss<0, 0>(s, dq + 2 * kk, dk + 2 * kk, kk);
      wgmma_commit();
    };

    mbar_wait(&sm.qbar, 0);
    mbar_wait(&sm.full[0], 0);
    issue_s(0);
    wgmma_wait<0>();
    fence_regs(s);
    // Each iteration: the softmax of tile it, then o += p v of tile it and
    // s of tile it + 1 in flight on the tensor cores while the hash of tile
    // it + 1 runs; every product is retired inside the iteration.
    for (int it = 0; it < n_iter; ++it) {
      const int st = it % k1::STAGES;
      const float* bias = sm.bias[st];
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 bb = *reinterpret_cast<const float2*>(bias + j * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = fmaf(s[4 * j + e], scale_log2, (e & 1) ? bb.y : bb.x);  // masked: exactly -1e30
          s[4 * j + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      float rs[2] = {0.f, 0.f};
      if (dropout) {  // the keep-mask hash, from the folded row terms and the producer's folded column terms
        const int k0 = (kt_lo + it) * BK;
        const uint32_t mixmul = block_mix(seed, b, q0 / mbq, k0 / mbk);
        const uint32_t a[2] = {fold16(mixmul ^ row_term[0]), fold16(mixmul ^ row_term[1])};
        const uint32_t* cx = sm.colx[st];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint2 cc = *reinterpret_cast<const uint2*>(cx + j * 8 + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            const float x = ex2(s[i] - mx[e >> 1]);
            rs[e >> 1] += x;
            s[i] = keep_bit_folded(a[e >> 1] ^ ((e & 1) ? cc.y : cc.x), thresh) ? x * keep_scale : 0.f;
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const float x = ex2(s[i] - mx[(i >> 1) & 1]);
          s[i] = x;
          rs[(i >> 1) & 1] += x;
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
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= corr[(i >> 1) & 1];
      hopper::pack_a(pa, s);

      // o += p v: p from registers, v MN-major
      const uint64_t dv = sw128_desc(sm.v[st]);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) wgmma_rs<1>(acc, pa + 4 * kc, dv + 128 * kc, 1);
      wgmma_commit();
      if (it + 1 < n_iter) {
        const int nst = (it + 1) % k1::STAGES;
        mbar_wait(&sm.full[nst], ((it + 1) / k1::STAGES) & 1);
        issue_s(nst);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(s);
      mbar_arrive(&sm.empty[st]);
    }

    const int ld = H * DH;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qrow0 + 8 * r;
      if (row >= Lq) continue;
      const float l = l_r[r];
      const float inv = l == 0.f ? 0.f : 1.f / l;
      const float lse_r = l == 0.f ? 0.f : m_r[r] * LN2 + logf(l);
      if (n_split == 1) {
        bf16* orow = o + ((size_t)b * Lq + row) * ld + h * DH;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 2 * t) =
              __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
        if (t == 0) lse[((size_t)b * H + h) * Lq + row] = lse_r;
      } else {
        float* orow = o_part + (((size_t)split * B + b) * Lq + row) * ld + h * DH;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(orow + j * 8 + 2 * t) =
              make_float2(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
        if (t == 0) lse_part[(((size_t)split * B + b) * H + h) * Lq + row] = lse_r;
      }
    }
  }
}

// The merge of K1's key chunks: per (b, q, h), lse = log sum_i exp(lse_i)
// and o = sum_i exp(lse_i - lse) o_i, rounded to bf16. One thread per four
// columns of a head row.
__global__ void __launch_bounds__(256)
flash_fwd_tma_merge_kernel(const float* __restrict__ o_part, const float* __restrict__ lse_part,
                           bf16* __restrict__ o, float* __restrict__ lse, int B, int H, int Lq, int n_split) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)B * Lq * H * 16) return;
  const int d4 = (int)(i % 16);
  size_t rest = i / 16;
  const int h = (int)(rest % H);
  rest /= H;
  const int q = (int)(rest % Lq), b = (int)(rest / Lq);
  const size_t ld = (size_t)H * DH;
  const size_t stat = ((size_t)b * H + h) * Lq + q, stat_stride = (size_t)B * H * Lq;
  float mx = lse_part[stat];
  for (int s = 1; s < n_split; ++s) mx = fmaxf(mx, lse_part[s * stat_stride + stat]);
  const size_t col = ((size_t)b * Lq + q) * ld + h * DH + d4 * 4, col_stride = (size_t)B * Lq * ld;
  float tot = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < n_split; ++s) {
    const float w = expf(lse_part[s * stat_stride + stat] - mx);
    const float4 x = *reinterpret_cast<const float4*>(o_part + s * col_stride + col);
    tot += w;
    acc.x += w * x.x;
    acc.y += w * x.y;
    acc.z += w * x.z;
    acc.w += w * x.w;
  }
  const float inv = 1.f / tot;
  __nv_bfloat162 lo = __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
  __nv_bfloat162 hi = __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(o + col) = packed;
  if (d4 == 0) lse[stat] = mx + logf(tot);
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
  const int n_tiles = (Lk + BK - 1) / BK;
  if (n_split < 1 || per < 1 || (long)n_split * per < n_tiles || (long)(n_split - 1) * per >= n_tiles ||
      (n_split > 1 && (o_part == nullptr || lse_part == nullptr)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  int err = hopper::make_map_bf16(&tq, q, B, Lq, H * DH, 64);
  if (!err) err = hopper::make_map_bf16(&tk, k, B, Lk, H * DH, 64);
  if (!err) err = hopper::make_map_bf16(&tv, v, B, Lk, H * DH, 64);
  if (err) return err;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(flash_fwd_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, k1::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid((Lq + k1::ROWS - 1) / k1::ROWS, H, B * n_split);
  flash_fwd_tma_kernel<<<grid, k1::THREADS, k1::SMEM_BYTES, st>>>(
      tq, tk, tv, (const int*)kv_len, (const uint8_t*)kv_valid, (const int*)seed, (bf16*)o, (float*)lse,
      (float*)o_part, (float*)lse_part, B, H, Lq, Lk, mbq, mbk, n_split, per, rate, keep_scale, thresh);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return (int)e;
  const size_t n = (size_t)B * Lq * H * 16;
  flash_fwd_tma_merge_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      (const float*)o_part, (const float*)lse_part, (bf16*)o, (float*)lse, B, H, Lq, n_split);
  return (int)cudaGetLastError();
}
