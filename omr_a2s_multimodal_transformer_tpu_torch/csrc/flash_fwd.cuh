// The forward block of K1 and K1c (flash_fwd.cu: head-packed, dropout;
// K1c causal with a window) and of L1 and L2a (legacy_flash_fwd.cu:
// per-head, no dropout, heads of 64 or 128 columns, causal calls too),
// shared, and the merges of their key-chunk partials by lse.
//
// Per head, with M the dropout keep-mask (DROP only):
//   o   = (softmax(s * scale) * M / (1 - rate)) v,   s = q k^T
//   lse = log-sum-exp of the masked scores * scale (f32)
// over the keys a query may see: the key test of kv_len and kv_valid (L1
// takes no kv_valid) and, for a causal call, k <= q and (window > 0)
// k >= q - window.
//
// A block per (NCONS x 64 queries, head, batch row, key chunk) of NCONS + 1
// warpgroups: a producer (one warp: a thread issues TMA loads of
// 128-byte-swizzled 64-row x 64-column boxes, the block's Q tiles once,
// then a 4-stage K/V ring guarded by mbarriers; the lanes write each key
// tile's key test as an additive 0 / -1e30 bias and, with dropout, the
// first step of the hash folded into its column terms, fold16) and NCONS
// consumer warpgroups of 64 queries each that share the K/V tiles (a third
// of the L2 traffic of 64-query blocks at NCONS 3); setmaxnreg moves the
// producer's registers to them. Both products on wgmma: s = q k^T from
// shared memory (K-major q and k), o += p v with p from registers (bf16,
// the accumulator layout re-used as the A fragment) and v read MN-major,
// so no transpose copy. o += p v of tile i and s = q k^T of tile i + 1 are
// in flight together while the softmax and hash of tile i + 1 wait; every
// product is retired inside its loop iteration (a product left in flight
// across the loop's back edge made ptxas serialize the wgmma pipeline).
// The online softmax is kept in the log2 domain (one ex2 per score).
//
// A causal instance (K1c, L1, L2a) walks the key tiles of the block's band
// (key_tiles) in one chunk, runs no product on a tile outside the band of
// a consumer's 64 queries (tile_meets_band) and tests each score against
// the band (in_band); a head-packed one (K1c) loads every tile of its band.
// The per-head instances (PER_HEAD) also:
// - walk only the key tiles below kv_len[b];
// - skip a key tile with no key to see: the producer loads no K/V for it
//   and the consumers run no product on it (`live`);
// - give a query row that sees no key of its chunk a partial of weight 0
//   (o 0, lse -inf), and a row that sees no key at all o = 0 and lse = 0.
// The head-packed instances keep K1's arithmetic (K1's rows always see a
// key of every chunk: the model's memories are never empty): a row of K1c
// whose band holds no key it may see gets the mean of v (dropout applied)
// over the 64-key tiles its consumer ran, or o = 0 and lse = 0 where its
// consumer ran none.
//
// Layouts, as in flash_dq.cuh: a head-packed [B, L, H*64] tensor is a map
// of (H*64 columns, L rows, B) read at column h*64; a per-head [B, H, L, D]
// tensor (D % 8 == 0, D <= 64 NB) a map of (D columns, L rows, B*H) read at
// (64 x, row, b*H + h) for box x of NB. TMA's zero fill covers the columns
// past D and the rows past L; stores stop at D. A 128-wide head holds o in
// two 64 x 64 f32 accumulators and runs every product as two 64-column
// halves.
//
// The accumulator layout gives each thread query rows 16w + g and + 8 and
// key pairs 8j + 2t (the m16n8 fragment layout), and every instance hashes
// the same (b, h, q, k), so the keep-mask is the JAX kernel's bit for bit.
#pragma once

#include <math.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace k1 {

using namespace flash;

constexpr int STAGES = 4;
constexpr int TILE_BYTES = 64 * 64 * 2;  // one box

// NB 64-column boxes per tile row (a head of 64 or 128 columns)
template <int NCONS, int NB>
struct Smem {
  bf16 q[NCONS][NB][64 * 64];  // each box 1024-byte aligned (the struct is placed at a 1024-byte boundary)
  bf16 k[STAGES][NB][64 * 64];
  bf16 v[STAGES][NB][64 * 64];
  float bias[STAGES][64];  // 0 for a key to see, -1e30 for a masked one
  union {
    uint32_t colx[STAGES][64];  // fold16 of each key's hash column term (DROP)
    uint32_t live[STAGES];      // the tile holds a key to see (PER_HEAD; else it was not loaded)
  };
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
  uint64_t qbar;
};

template <int NCONS, int NB>
constexpr int smem_bytes() {
  return (int)sizeof(Smem<NCONS, NB>) + 1024;  // + room to align the base
}

// the consumers' registers after setmaxnreg: the producer warpgroup keeps 24 and the block has 64K
template <int NCONS>
constexpr int CONSUMER_REGS = NCONS == 2 ? 240 : 160;

template <int NCONS, int NB>
__device__ __forceinline__ Smem<NCONS, NB>& smem() {
  extern __shared__ unsigned char smem_raw[];
  return *reinterpret_cast<Smem<NCONS, NB>*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
}

// What a block computes: the NCONS x 64 queries of query tile qt, of batch
// row b and head h, over key chunk `split`.
struct Block {
  int qt, b, h, split;
};

// The block of a 3-D grid (x = query tile, y = head, z = b * n_split +
// split), as K1, L1 and L2a launch it.
__device__ __forceinline__ Block grid_block(int n_split) {
  return {(int)blockIdx.x, (int)(blockIdx.z / n_split), (int)blockIdx.y, (int)(blockIdx.z % n_split)};
}

// Block blk: key tiles [split * per, min(n_tiles, (split + 1) * per))
// (PER_HEAD: n_tiles below kv_len[b]), or for a causal call (n_split 1) the
// key tiles of its band. n_split == 1 writes o (bf16) and, with LSE, lse;
// otherwise the chunk's normalized f32 partial o (n_split slabs of o's
// shape) and its lse (n_split slabs of [B, H, Lq]) for a merge. LSE false
// (L1) reads no kv_valid and writes no lse.
template <int NCONS, bool CAUSAL, bool PER_HEAD, int NB, bool DROP, bool LSE>
__device__ __forceinline__ void fwd_block(const Block blk, const CUtensorMap* tq, const CUtensorMap* tk,
                                          const CUtensorMap* tv,
                                          const int* __restrict__ kv_len, const uint8_t* __restrict__ kv_valid,
                                          const int* __restrict__ seed_p, bf16* __restrict__ o,
                                          float* __restrict__ lse, float* __restrict__ o_part,
                                          float* __restrict__ lse_part, int B, int H, int Lq, int Lk, int D, int mbq,
                                          int mbk, int window, int n_split, int per, float scale, float rate,
                                          float keep_scale, uint32_t thresh) {
  using namespace hopper;
  static_assert(PER_HEAD || (NB == 1 && LSE), "the head-packed block is K1's and K1c's: 64 columns, lse out");
  static_assert(!(PER_HEAD && DROP), "the per-head block has no dropout");
  constexpr int ROWS = 64 * NCONS;
  Smem<NCONS, NB>& sm = smem<NCONS, NB>();
  const int qt = blk.qt, h = blk.h, b = blk.b, split = blk.split;
  const int2 at = tile_at<PER_HEAD>(b, h, H);
  // the head-packed block walks every key tile; the per-head one only those below kv_len
  const int n_tiles = ((PER_HEAD ? min(kv_len[b], Lk) : Lk) + BK - 1) / BK;
  int kt_lo, kt_hi;
  if (CAUSAL) {
    key_tiles<true>(qt * ROWS, n_tiles, window, kt_lo, kt_hi, ROWS);
  } else {
    kt_lo = split * per;
    kt_hi = min(n_tiles, kt_lo + per) - 1;
  }
  // K1: >= 1 (the wrapper's split); causal or per-head: <= 0 for a chunk past kv_len or a band with no key tile
  const int n_iter = kt_hi - kt_lo + 1;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 32);            // the producer warp's lanes (lane 0 also expects the TMA bytes)
      mbar_init(&sm.empty[s], 128 * NCONS);  // every consumer thread
    }
    mbar_init(&sm.qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one warp; the warpgroup gives up its registers
    reg_dealloc<24>();
    const int lane = threadIdx.x;
    if (lane < 32 && ((!PER_HEAD && !CAUSAL) || n_iter > 0)) {
      const bool dropout = DROP && rate > 0.f;
      const int len = min(kv_len[b], Lk);
      const uint8_t* validb = kv_valid + (size_t)b * Lk;
      if (lane == 0) {
        mbar_arrive_expect_tx(&sm.qbar, NCONS * NB * TILE_BYTES);
        for (int c = 0; c < NCONS; ++c) {
          for (int x = 0; x < NB; ++x) tma_load_3d(sm.q[c][x], tq, &sm.qbar, at.x + 64 * x, qt * ROWS + 64 * c, at.y);
        }
      }
      // each lane tests keys lane and lane + 32 of a tile; the next tile's
      // test is loaded before the wait for its stage
      auto key_test = [&](int k0, int i) { return k0 + i < len && (!LSE || validb[k0 + i] != 0); };
      bool ok0 = key_test(kt_lo * BK, lane), ok1 = key_test(kt_lo * BK, lane + 32);
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % STAGES;
        const int k0 = (kt_lo + it) * BK;
        const bool cur0 = ok0, cur1 = ok1;
        if (it + 1 < n_iter) {
          ok0 = key_test(k0 + BK, lane);
          ok1 = key_test(k0 + BK, lane + 32);
        }
        mbar_wait(&sm.empty[s], ((it / STAGES) & 1) ^ 1);
        sm.bias[s][lane] = cur0 ? 0.f : NEG_INF;
        sm.bias[s][lane + 32] = cur1 ? 0.f : NEG_INF;
        if (dropout) {
          const uint32_t c0 = (uint32_t)(k0 % mbk + lane);  // a key tile lies inside one mask k-block
          sm.colx[s][lane] = fold16(c0 * COL_MUL);
          sm.colx[s][lane + 32] = fold16((c0 + 32) * COL_MUL);
        }
        const bool live = !PER_HEAD || __any_sync(0xffffffffu, cur0 || cur1);
        if (lane == 0) {
          if (PER_HEAD) sm.live[s] = live;
          if (live) {
            mbar_arrive_expect_tx(&sm.full[s], 2 * NB * TILE_BYTES);
            for (int x = 0; x < NB; ++x) tma_load_3d(sm.k[s][x], tk, &sm.full[s], at.x + 64 * x, k0, at.y);
            for (int x = 0; x < NB; ++x) tma_load_3d(sm.v[s][x], tv, &sm.full[s], at.x + 64 * x, k0, at.y);
          } else {
            mbar_arrive(&sm.full[s]);
          }
        } else {
          mbar_arrive(&sm.full[s]);
        }
      }
    }
  } else {
    // ---- consumers: 64 queries each
    reg_alloc<CONSUMER_REGS<NCONS>>();
    const int c = wg - 1;
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int q0 = qt * ROWS + c * 64;
    const int qrow0 = q0 + warp * 16 + g;  // rows qrow0 and qrow0 + 8
    const bool dropout = DROP && rate > 0.f;
    const int seed = dropout ? *seed_p : 0;
    const float scale_log2 = scale * LOG2E;
    // hash row terms; a 64-query tile lies inside one mask q-block (mbq % 64 == 0)
    const uint32_t row_term[2] = {DROP ? (uint32_t)(h * mbq + qrow0 % mbq) * ROW_MUL : 0u,
                                  DROP ? (uint32_t)(h * mbq + (qrow0 + 8) % mbq) * ROW_MUL : 0u};
    float acc[NB][32], s[32];
    uint32_t pa[16];
#pragma unroll
    for (int x = 0; x < NB; ++x) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[x][i] = 0.f;
    }
    float m_r[2] = {NEG_INF, NEG_INF};  // running max, log2 domain; NEG_INF until a key is seen
    float l_r[2] = {0.f, 0.f};

    if ((!PER_HEAD && !CAUSAL) || n_iter > 0) {
      uint64_t dQ[NB];
#pragma unroll
      for (int x = 0; x < NB; ++x) dQ[x] = sw128_desc(sm.q[c][x]);
      // s = q k^T (64 x 64) of the tile in stage st
      auto issue_s = [&](int st) {
        wgmma_fence();
#pragma unroll
        for (int x = 0; x < NB; ++x) {
          const uint64_t dK = sw128_desc(sm.k[st][x]);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) wgmma_ss<0, 0>(s, dQ[x] + 2 * kk, dK + 2 * kk, 4 * x + kk);
        }
        wgmma_commit();
      };

      // Whether this warpgroup runs the products of the tile of iteration it (in stage st), the same for
      // its every thread: not on a tile with no key to see (PER_HEAD) or, for a causal call, with no key
      // in the band of any of its 64 queries.
      auto runs = [&](int it, int st) {
        const int k0 = (kt_lo + it) * BK;
        return (!PER_HEAD || sm.live[st] != 0) && (!CAUSAL || tile_meets_band(q0, k0, window));
      };
      mbar_wait(&sm.qbar, 0);
      mbar_wait(&sm.full[0], 0);
      bool run = runs(0, 0);
      if (run) issue_s(0);
      wgmma_wait<0>();
      fence_regs(s);
      // Each iteration: the softmax of tile it, then o += p v of tile it and
      // s of tile it + 1 in flight on the tensor cores while the hash of tile
      // it + 1 runs; every product is retired inside the iteration.
      for (int it = 0; it < n_iter; ++it) {
        const int st = it % STAGES;
        if (run) {
          const float* bias = sm.bias[st];
          const int k0 = (kt_lo + it) * BK;
          float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 bb = *reinterpret_cast<const float2*>(bias + j * 8 + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float x = fmaf(s[4 * j + e], scale_log2, (e & 1) ? bb.y : bb.x);  // masked: exactly -1e30
              if (CAUSAL && !in_band<true>(qrow0 + 8 * (e >> 1), k0 + j * 8 + 2 * t + (e & 1), window)) x = NEG_INF;
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
          for (int x = 0; x < NB; ++x) {
#pragma unroll
            for (int i = 0; i < 32; ++i) acc[x][i] *= corr[(i >> 1) & 1];
          }
          hopper::pack_a(pa, s);

          // o += p v: p from registers, v MN-major
          wgmma_fence();
#pragma unroll
          for (int x = 0; x < NB; ++x) {
            const uint64_t dV = sw128_desc(sm.v[st][x]);
#pragma unroll
            for (int kc = 0; kc < 4; ++kc) wgmma_rs<1>(acc[x], pa + 4 * kc, dV + 128 * kc, 1);
          }
          wgmma_commit();
        }
        if (it + 1 < n_iter) {
          const int nst = (it + 1) % STAGES;
          mbar_wait(&sm.full[nst], ((it + 1) / STAGES) & 1);
          run = runs(it + 1, nst);
          if (run) issue_s(nst);
        }
        wgmma_wait<0>();
#pragma unroll
        for (int x = 0; x < NB; ++x) fence_regs(acc[x]);
        fence_regs(s);
        mbar_arrive(&sm.empty[st]);
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qrow0 + 8 * r;
      if (row >= Lq) continue;
      const float l = l_r[r];
      if (PER_HEAD) {
        // a row that saw no key of this chunk: weight 0 in the merge (lse -inf), or o = 0, lse = 0 alone
        const bool seen = m_r[r] > NEG_INF;
        const float inv = seen ? 1.f / l : 0.f;
        const float lse_r = m_r[r] * LN2 + logf(l);
        const size_t off = row_offset<true>(b, h, H, Lq, D, row);
        const size_t stat = ((size_t)b * H + h) * Lq + row;
#pragma unroll
        for (int x = 0; x < NB; ++x) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = 64 * x + j * 8 + 2 * t;
            if (64 * x + j * 8 >= D) continue;
            if (n_split == 1)
              *reinterpret_cast<__nv_bfloat162*>(o + off + col) =
                  __floats2bfloat162_rn(acc[x][4 * j + 2 * r] * inv, acc[x][4 * j + 2 * r + 1] * inv);
            else
              *reinterpret_cast<float2*>(o_part + (size_t)split * B * H * Lq * D + off + col) =
                  make_float2(acc[x][4 * j + 2 * r] * inv, acc[x][4 * j + 2 * r + 1] * inv);
          }
        }
        if (t == 0) {
          if (n_split > 1)
            lse_part[(size_t)split * B * H * Lq + stat] = seen ? lse_r : -INFINITY;
          else if (LSE)
            lse[stat] = seen ? lse_r : 0.f;
        }
      } else {
        const int ld = H * DH;
        const float inv = l == 0.f ? 0.f : 1.f / l;
        const float lse_r = l == 0.f ? 0.f : m_r[r] * LN2 + logf(l);
        if (n_split == 1) {
          bf16* orow = o + ((size_t)b * Lq + row) * ld + h * DH;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 2 * t) =
                __floats2bfloat162_rn(acc[0][4 * j + 2 * r] * inv, acc[0][4 * j + 2 * r + 1] * inv);
          if (t == 0) lse[((size_t)b * H + h) * Lq + row] = lse_r;
        } else {
          float* orow = o_part + (((size_t)split * B + b) * Lq + row) * ld + h * DH;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<float2*>(orow + j * 8 + 2 * t) =
                make_float2(acc[0][4 * j + 2 * r] * inv, acc[0][4 * j + 2 * r + 1] * inv);
          if (t == 0) lse_part[(((size_t)split * B + b) * H + h) * Lq + row] = lse_r;
        }
      }
    }
  }
}

constexpr int MERGE_THREADS = 256;

// Four bf16 values (8 bytes) from four floats times inv.
__device__ __forceinline__ void store_bf16x4(bf16* dst, float4 acc, float inv) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
  __nv_bfloat162 hi = __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = packed;
}

// The merge of K1's key chunks on the head-packed layout: per (b, q, h),
// lse = log sum_i exp(lse_i) and o = sum_i exp(lse_i - lse) o_i, rounded to
// bf16. One thread per four columns of a head row.
__device__ __forceinline__ void merge_packed(const float* __restrict__ o_part, const float* __restrict__ lse_part,
                                             bf16* __restrict__ o, float* __restrict__ lse, int B, int H, int Lq,
                                             int n_split) {
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
  store_bf16x4(o + col, acc, 1.f / tot);
  if (d4 == 0) lse[stat] = mx + logf(tot);
}

// The merge of the per-head key chunks: `rows` rows of D columns (o
// [rows, D] bf16; partials [n_split, rows, D] and [n_split, rows] f32), in
// chunk order. A chunk whose lse is -inf (the row saw no key in it) weighs
// 0; a row that saw no key in any chunk gets o = 0 and lse = 0. lse may be
// null (L1). One thread per four columns of a row.
__device__ __forceinline__ void merge_rows(const float* __restrict__ o_part, const float* __restrict__ lse_part,
                                           bf16* __restrict__ o, float* __restrict__ lse, size_t rows, int D,
                                           int n_split) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int d4n = D / 4;
  if (i >= rows * d4n) return;
  const size_t row = i / d4n;
  const int d4 = (int)(i % d4n);
  float mx = lse_part[row];
  for (int s = 1; s < n_split; ++s) mx = fmaxf(mx, lse_part[s * rows + row]);
  const size_t col = row * D + d4 * 4;
  float tot = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (mx > -INFINITY) {
    for (int s = 0; s < n_split; ++s) {
      const float w = expf(lse_part[s * rows + row] - mx);  // 0 for a chunk with no key
      const float4 x = *reinterpret_cast<const float4*>(o_part + s * rows * D + col);
      tot += w;
      acc.x += w * x.x;
      acc.y += w * x.y;
      acc.z += w * x.z;
      acc.w += w * x.w;
    }
  }
  const bool seen = tot > 0.f;
  store_bf16x4(o + col, acc, seen ? 1.f / tot : 0.f);
  if (lse != nullptr && d4 == 0) lse[row] = seen ? mx + logf(tot) : 0.f;
}

// The arguments a forward launch checks: n_split chunks of `per` key tiles
// that cover the tiles with none empty (a causal call: one chunk), and
// partial buffers where there is more than one.
inline bool valid_split(int Lk, int causal, int n_split, int per, const void* o_part, const void* lse_part) {
  const int n_tiles = (Lk + BK - 1) / BK;
  return n_split >= 1 && per >= 1 && !(causal && n_split != 1) &&
         (causal || ((long)n_split * per >= n_tiles && (long)(n_split - 1) * per < n_tiles)) &&
         !(n_split > 1 && (o_part == nullptr || lse_part == nullptr));
}

}  // namespace k1
