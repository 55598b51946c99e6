// The backward block of K2 (flash_bwd.cu: dq, dk and dv) and K3b
// (flash_dkv.cu: dk and dv of the split backward, causal or not), shared.
//
// Per head h, with p = exp(s - lse) on the keys a query may see (0
// elsewhere), M the dropout keep-mask regenerated from the same hash as the
// forward and delta = rowsum(do * o) per (b, h, q) computed by the caller:
//   dp = (do v^T) * M / (1 - rate),  ds = p * (dp - delta) / 8
//   dv = (p * M / (1 - rate))^T do,  dk = ds^T q,  dq = ds k (K2 only)
// p_drop and ds are rounded to bf16 before their products, as in the TPU
// kernel.
//
// A block of three warpgroups per (128-key block, head, batch row): a
// producer (one warp: a thread issues TMA loads, the block's K and V tiles
// once, then a 3-stage ring of 64-query Q and dO tiles, 128-byte-swizzled,
// and a bulk copy of each tile's (lse * log2 e, delta) pairs; the lanes
// write the tile's folded hash row terms), and two consumer warpgroups of
// 64 keys each that share the ring (half the L2 traffic of 64-key blocks);
// setmaxnreg moves the producer's registers to them. The products run on
// wgmma in the transposed frame: s^T = k q^T and dp^T = v do^T from shared
// memory, dv += p_drop^T do and dk += ds^T q with A from registers and do, q
// read MN-major. The keep-mask hash of a tile runs while s^T and dp^T are in
// flight, its first step folded into per-key and per-query terms (fold16).
// dk and dv accumulate in registers over the query tiles and are written
// once, so they are bitwise deterministic.
//
// DQ (K2) adds dq = ds k: ds^T is staged in shared memory (MN-major A) and
// each warpgroup's 64 x 64 f32 partial is added into a f32 [B, Lq, H*64]
// buffer by two bulk tensor reduce-adds per query tile (the order of those
// adds across key blocks changes from run to run). Without DQ (K3b) a
// consumer whose 64 keys are all invalid runs no product. CAUSAL (K3b only)
// walks the query tiles that may see the block's keys (query_tiles) and
// tests each score against the band.
// The accumulator layout gives each thread keys 16w + g and + 8 and query
// pairs 8j + 2t, the layout of the mma.sync kernels, so the hoisted hash
// terms, and the keep-mask, are the same as the forward's.
#pragma once

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace k2 {

using namespace flash;

constexpr int STAGES = 3;
constexpr int THREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr int KEYS = 128;     // keys per block, 64 per consumer warpgroup
constexpr int TILE_BYTES = 64 * 64 * 2;
constexpr int STAT_BYTES = 64 * 2 * 4;  // (lse * log2 e, delta) of 64 queries

// dq's staging (K2 only)
template <bool DQ>
struct DqStage {
  bf16 ds[2][64 * 64];      // ds^T of each warpgroup: [key][query], the MN-major A of dq = ds k
  float dq[2][2][64 * 32];  // dq partial of each warpgroup: two 32-column halves of 128-byte rows
};

template <>
struct DqStage<false> {};

template <bool DQ>
struct Smem {
  bf16 k[2][64 * 64];  // every tile 1024-byte aligned (the struct is placed at a 1024-byte boundary)
  bf16 v[2][64 * 64];
  bf16 q[STAGES][64 * 64];
  bf16 dout[STAGES][64 * 64];
  DqStage<DQ> stage;
  alignas(16) float stats[STAGES][64 * 2];
  uint32_t rowx[STAGES][64];  // fold16 of each query's hash row term (dropout only)
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
  uint64_t kvbar;
};

template <bool DQ>
constexpr int smem_bytes() {
  return (int)sizeof(Smem<DQ>) + 1024;  // + room to align the base
}

template <bool DQ>
__device__ __forceinline__ Smem<DQ>& smem() {
  extern __shared__ unsigned char smem_raw[];
  return *reinterpret_cast<Smem<DQ>*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
}

// The block (blockIdx.x = 128-key block, y = head, z = batch row). stats is
// [B, H, ceil(Lq / 64) * 64, 2] f32: (lse * log2 e, delta), zero past Lq.
// tdq (DQ only) maps the zeroed f32 [B, Lq, H*64] that the bulk reductions
// add into; window is the band's (CAUSAL only; <= 0: none).
template <bool DQ, bool CAUSAL>
__device__ __forceinline__ void bwd_block(const CUtensorMap* tq, const CUtensorMap* tdo, const CUtensorMap* tk,
                                          const CUtensorMap* tv, const CUtensorMap* tdq,
                                          const int* __restrict__ kv_len, const uint8_t* __restrict__ kv_valid,
                                          const int* __restrict__ seed_p, const float* __restrict__ stats,
                                          bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Lq, int Lk,
                                          int mbq, int mbk, int window, float rate, float keep_scale,
                                          uint32_t thresh) {
  using namespace hopper;
  Smem<DQ>& sm = smem<DQ>();
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * KEYS;
  const int nqt = (Lq + BQ - 1) / BQ;
  int qt_lo, qt_hi;
  query_tiles<CAUSAL>(k0, nqt, window, qt_lo, qt_hi, KEYS);
  const int n_iter = qt_hi - qt_lo + 1;  // <= 0: no query sees these keys; dk = dv = 0
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 32);    // the producer warp's lanes (lane 0 also expects the copies' bytes)
      mbar_init(&sm.empty[s], 256);  // every consumer thread
    }
    mbar_init(&sm.kvbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one warp (lane 0 issues the copies); the warpgroup gives up its registers
    reg_dealloc<24>();
    const int lane = threadIdx.x;
    if (lane < 32) {
      const bool dropout = rate > 0.f;
      if (lane == 0) {
        mbar_arrive_expect_tx(&sm.kvbar, 4 * TILE_BYTES);
        for (int c = 0; c < 2; ++c) {
          tma_load_3d(sm.k[c], tk, &sm.kvbar, h * DH, k0 + 64 * c, b);
          tma_load_3d(sm.v[c], tv, &sm.kvbar, h * DH, k0 + 64 * c, b);
        }
      }
      const float* stats_bh = stats + ((size_t)b * H + h) * nqt * BQ * 2;
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % STAGES;
        const int q0 = (qt_lo + it) * BQ;
        mbar_wait(&sm.empty[s], ((it / STAGES) & 1) ^ 1);
        if (dropout) {  // a 64-query tile lies inside one mask q-block: row = h*mbq + q % mbq
          const uint32_t r0 = (uint32_t)(h * mbq + q0 % mbq + lane);
          sm.rowx[s][lane] = fold16(r0 * ROW_MUL);
          sm.rowx[s][lane + 32] = fold16((r0 + 32) * ROW_MUL);
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&sm.full[s], 2 * TILE_BYTES + STAT_BYTES);
          tma_load_3d(sm.q[s], tq, &sm.full[s], h * DH, q0, b);
          tma_load_3d(sm.dout[s], tdo, &sm.full[s], h * DH, q0, b);
          bulk_load(sm.stats[s], stats_bh + (size_t)q0 * 2, STAT_BYTES, &sm.full[s]);
        } else {
          mbar_arrive(&sm.full[s]);
        }
      }
    }
  } else {
    // ---- consumers: 64 keys each
    reg_alloc<240>();
    const int c = wg - 1;
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int kc0 = k0 + 64 * c;
    const int len = min(kv_len[b], Lk);
    const bool dropout = rate > 0.f;
    const int seed = dropout ? *seed_p : 0;
    const float scale = 0.125f;  // 1/sqrt(64)
    // keys owned by this thread: r = 0 -> kc0 + 16w + g, r = 1 -> + 8
    const int krow[2] = {kc0 + warp * 16 + g, kc0 + warp * 16 + g + 8};
    bool kval[2];
    uint32_t col_term[2];  // hash column terms; a 64-key tile lies inside one mask k-block
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      kval[r] = key_valid(kv_valid + (size_t)b * Lk, len, krow[r]);
      col_term[r] = (uint32_t)(krow[r] % mbk) * COL_MUL;
    }
    float dk_acc[32], dv_acc[32], st[32], dpt[32], mult[32];
    uint32_t pp[16], pd[16];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    // K3b: a warpgroup whose 64 keys are all invalid runs no product (dk = dv = 0)
    bool live = true;
    if constexpr (!DQ) live = named_any(1 + c, 128, kval[0] || kval[1]);

    mbar_wait(&sm.kvbar, 0);
    const uint64_t dK = sw128_desc(sm.k[c]), dV = sw128_desc(sm.v[c]);
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % STAGES;
      const int q0 = (qt_lo + it) * BQ;
      mbar_wait(&sm.full[s], (it / STAGES) & 1);
      if (!live) {
        mbar_arrive(&sm.empty[s]);
        continue;
      }
      const uint64_t dQ = sw128_desc(sm.q[s]), dO = sw128_desc(sm.dout[s]);

      // s^T = k q^T and dp^T = v do^T (64 keys x 64 queries), in flight while the hash runs
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss<0, 0>(st, dK + 2 * kk, dQ + 2 * kk, kk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss<0, 0>(dpt, dV + 2 * kk, dO + 2 * kk, kk);
      wgmma_commit();
      if (dropout) {  // from the folded key terms and the producer's folded query terms
        const uint32_t mixmul = block_mix(seed, b, q0 / mbq, kc0 / mbk);
        const uint32_t a[2] = {fold16(mixmul ^ col_term[0]), fold16(mixmul ^ col_term[1])};
        const uint32_t* rx = sm.rowx[s];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint2 rr = *reinterpret_cast<const uint2*>(rx + j * 8 + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mult[4 * j + e] = keep_bit_folded(a[e >> 1] ^ ((e & 1) ? rr.y : rr.x), thresh) ? keep_scale : 0.f;
        }
      }
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      const float* L = sm.stats[s];
      const int qlim = Lq - q0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e, r = e >> 1;
          const int qc = j * 8 + 2 * t + (e & 1);
          const float2 ld = *reinterpret_cast<const float2*>(L + 2 * qc);  // (lse * log2 e, delta)
          const bool see = kval[r] && qc < qlim && in_band<CAUSAL>(q0 + qc, krow[r], window);
          const float p = see ? ex2(st[i] * (scale * LOG2E) - ld.x) : 0.f;
          float dp = dpt[i];
          float p_drop = p;
          if (dropout) {
            p_drop = p * mult[i];
            dp = dp * mult[i];
          }
          st[i] = p_drop;
          dpt[i] = p * (dp - ld.y) * scale;  // ds
        }
      }
      hopper::pack_a(pp, st);
      hopper::pack_a(pd, dpt);
      if constexpr (DQ) {
        // ds^T (bf16) to shared memory, 128-byte swizzled: row = key, chunk j ^ (row % 8)
        unsigned char* ds_tile = reinterpret_cast<unsigned char*>(sm.stage.ds[c]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = warp * 16 + g + 8 * r;
            *reinterpret_cast<uint32_t*>(ds_tile + row * 128 + ((j ^ g) << 4) + 4 * t) = pd[2 * j + r];
          }
        }
        fence_proxy_async();
      }

      // dv += p_drop^T do, dk += ds^T q: A from registers, do and q MN-major
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) wgmma_rs<1>(dv_acc, pp + 4 * kc, dO + 128 * kc, 1);
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) wgmma_rs<1>(dk_acc, pd + 4 * kc, dQ + 128 * kc, 1);
      wgmma_commit();
      if constexpr (DQ) {
        float dq[32];
        float* dq_tile = &sm.stage.dq[c][0][0];
        const uint64_t dS = sw128_desc(sm.stage.ds[c]);
        named_sync(1 + c, 128);  // the warpgroup's ds^T is in shared memory

        // dq partial (64 queries x 64) = ds k: A = ds^T read MN-major, B = k MN-major
        fence_regs(dq);
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) wgmma_ss<1, 1>(dq, dS + 128 * kc, dK + 128 * kc, kc);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        fence_regs(dk_acc);
        fence_regs(dv_acc);
        mbar_arrive(&sm.empty[s]);

        // the previous partial's reduce-add has read the staging tile
        if (tid == 0) bulk_wait_read();
        named_sync(1 + c, 128);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = warp * 16 + g + 8 * r;
            const int chunk = 2 * (j & 3) + (t >> 1);
            float* dst = dq_tile + (j >> 2) * 2048 + row * 32 + ((chunk ^ g) << 2) + 2 * (t & 1);
            *reinterpret_cast<float2*>(dst) = make_float2(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
          }
        }
        fence_proxy_async();
        named_sync(1 + c, 128);
        if (tid == 0) {
          tma_reduce_add_3d(tdq, dq_tile, h * DH, q0, b);
          tma_reduce_add_3d(tdq, dq_tile + 2048, h * DH + 32, q0, b);
          bulk_commit();
        }
      } else {
        wgmma_wait<0>();
        fence_regs(dk_acc);
        fence_regs(dv_acc);
        mbar_arrive(&sm.empty[s]);
      }
    }
    if constexpr (DQ) {
      if (tid == 0) bulk_wait();  // the last reduce-adds are done before the block's shared memory goes
    }

    const int ld = H * DH;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (krow[r] >= Lk) continue;
      bf16* dkrow = dk + ((size_t)b * Lk + krow[r]) * ld + h * DH;
      bf16* dvrow = dv + ((size_t)b * Lk + krow[r]) * ld + h * DH;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(dkrow + j * 8 + 2 * t) =
            __floats2bfloat162_rn(dk_acc[4 * j + 2 * r], dk_acc[4 * j + 2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dvrow + j * 8 + 2 * t) =
            __floats2bfloat162_rn(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

}  // namespace k2
