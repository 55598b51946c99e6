// K3a: dq of the split flash attention backward.
//
// Replaces omr_a2s_multimodal_transformer_tpu/ops/flash_packed.py
// _dq_kernel (:228), which the JAX backward runs, before _dkv_kernel, for
// every causal, windowed or merged_bwd=False call (:581). Per head h, with
// p = exp(s - lse) on the keys the query may see (0 elsewhere), M the
// dropout keep-mask regenerated from the forward's hash and
// delta = rowsum(do * o) per (b, h, q) computed by the caller:
//   dp = (do v^T) * M / (1 - rate),  ds = p * (dp - delta) / 8,  dq = ds k
// ds is rounded to bf16 before its product, as in the TPU kernel.
//
// What bounds it on the H100: three products, 6*H*64 FLOP per (query, key)
// pair the query sees (0.17 ms non-causal at the cross shape); the CUDA
// cores set the pace first, with an exp, the ds arithmetic and, with
// dropout, the keep-mask hash per score. At the paper's window (100) each
// query sees at most 101 keys against 768 bytes of q, k, v, do and dq per
// query and head, so bytes bound it. The design is K1's layout
// (flash_fwd.cu) with the backward's arithmetic:
// - a block per (NCONS x 64 queries, head, batch row, key chunk) of
//   NCONS + 1 warpgroups (3 for a non-causal call, 2 for a causal one,
//   whose band is short): a producer (one warp: a thread issues TMA loads of
//   128-byte-swizzled 64 x 64 tiles, the block's Q and dO tiles once, then a
//   4-stage K/V ring guarded by mbarriers; the lanes write each key tile's
//   key test as a 64-bit mask and, with dropout, the first step of the hash
//   folded into its column terms, fold16) and NCONS consumer warpgroups of
//   64 queries each that share the K/V tiles; setmaxnreg moves the
//   producer's registers to them. Each consumer holds lse * log2 e and
//   delta for its rows;
// - per key tile, s = q k^T and dp = do v^T on wgmma from shared memory,
//   the keep-mask hash of that tile while both are in flight, then p and ds
//   in f32, and dq += ds k on wgmma with ds (bf16) as the register A
//   operand (the accumulator layout re-used as the A fragment) and k read
//   MN-major. dq += ds k of tile i and s, dp of tile i + 1 are in flight
//   together; every product is retired inside its loop iteration;
// - no wave tail: a non-causal call splits its key tiles into chunks
//   (chosen by the wrapper for the SM count, dq_splits), each writing an
//   f32 dq partial; a second kernel sums the partials in chunk order and
//   rounds to bf16. No atomics: dq is bitwise deterministic. A causal call
//   walks the key tiles of its band (key_tiles) in one chunk and tests each
//   score against the band;
// - a key tile with no valid key (kv_valid, kv_len: the ragged images'
//   memories hold 8% of such tiles) runs no product.
// The accumulator layout gives each thread query rows 16w + g and + 8 and
// key pairs 8j + 2t, K1's frame, so the hoisted hash terms and the
// keep-mask are the forward's bit for bit.
#include "flash_common.cuh"
#include "hopper_common.cuh"

using namespace flash;

namespace k3a {

constexpr int STAGES = 4;
constexpr int TILE_BYTES = 64 * 64 * 2;

template <int NCONS>
struct Smem {
  bf16 q[NCONS][64 * 64];  // each 1024-byte aligned (the struct is placed at a 1024-byte boundary)
  bf16 dout[NCONS][64 * 64];
  bf16 k[STAGES][64 * 64];
  bf16 v[STAGES][64 * 64];
  uint64_t kmask[STAGES];     // bit i: key k0 + i passes the key test (kv_len, kv_valid)
  uint32_t colx[STAGES][64];  // fold16 of each key's hash column term (dropout only)
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
  uint64_t qbar;
};

template <int NCONS>
constexpr int smem_bytes() {
  return (int)sizeof(Smem<NCONS>) + 1024;  // + room to align the base
}

// the consumers' registers after setmaxnreg: the producer warpgroup keeps 24 and the block has 64K
template <int NCONS>
constexpr int CONSUMER_REGS = NCONS == 2 ? 240 : 160;

template <int NCONS>
__device__ __forceinline__ Smem<NCONS>& smem() {
  extern __shared__ unsigned char smem_raw[];
  return *reinterpret_cast<Smem<NCONS>*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
}

}  // namespace k3a

// grid (ceil(Lq / (64 NCONS)), H, B * n_split); block z = b * n_split + split
// walks key tiles [split * per, min(n_tiles, (split + 1) * per)), or for a
// causal call (n_split 1) the key tiles of its band. stats is [B, H,
// ceil(Lq / 64) * 64, 2] f32: (lse * log2 e, delta). n_split == 1 writes dq
// (bf16); otherwise the chunk's f32 partial, [n_split, B, Lq, H*64].
template <int NCONS, bool CAUSAL>
__global__ void __launch_bounds__(128 * (NCONS + 1), 1)
flash_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                const int* __restrict__ kv_len, const uint8_t* __restrict__ kv_valid, const int* __restrict__ seed_p,
                const float* __restrict__ stats, bf16* __restrict__ dq, float* __restrict__ dq_part, int B, int H,
                int Lq, int Lk, int mbq, int mbk, int window, int n_split, int per, float rate, float keep_scale,
                uint32_t thresh) {
  using namespace hopper;
  constexpr int ROWS = 64 * NCONS;
  k3a::Smem<NCONS>& sm = k3a::smem<NCONS>();
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z / n_split, split = blockIdx.z % n_split;
  const int n_tiles = (Lk + BK - 1) / BK;
  int kt_lo, kt_hi;
  if (CAUSAL) {
    key_tiles<true>(qt * ROWS, n_tiles, window, kt_lo, kt_hi, ROWS);
  } else {
    kt_lo = split * per;
    kt_hi = min(n_tiles, kt_lo + per) - 1;
  }
  const int n_iter = kt_hi - kt_lo + 1;  // >= 1 but for a causal block with no key tile in its band (dq = 0)
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < k3a::STAGES; ++s) {
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
    if (lane < 32 && n_iter > 0) {
      const bool dropout = rate > 0.f;
      const int len = min(kv_len[b], Lk);
      const uint8_t* validb = kv_valid + (size_t)b * Lk;
      if (lane == 0) {
        mbar_arrive_expect_tx(&sm.qbar, 2 * NCONS * k3a::TILE_BYTES);
        for (int c = 0; c < NCONS; ++c) {
          tma_load_3d(sm.q[c], &tq, &sm.qbar, h * DH, qt * ROWS + 64 * c, b);
          tma_load_3d(sm.dout[c], &tdo, &sm.qbar, h * DH, qt * ROWS + 64 * c, b);
        }
      }
      // each lane tests keys lane and lane + 32 of a tile; the next tile's
      // test is loaded before the wait for its stage
      auto key_test = [&](int k0, int i) { return k0 + i < len && validb[k0 + i] != 0; };
      bool ok0 = key_test(kt_lo * BK, lane), ok1 = key_test(kt_lo * BK, lane + 32);
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % k3a::STAGES;
        const int k0 = (kt_lo + it) * BK;
        const bool cur0 = ok0, cur1 = ok1;
        if (it + 1 < n_iter) {
          ok0 = key_test(k0 + BK, lane);
          ok1 = key_test(k0 + BK, lane + 32);
        }
        mbar_wait(&sm.empty[s], ((it / k3a::STAGES) & 1) ^ 1);
        const uint32_t m0 = __ballot_sync(0xffffffffu, cur0), m1 = __ballot_sync(0xffffffffu, cur1);
        if (dropout) {
          const uint32_t c0 = (uint32_t)(k0 % mbk + lane);  // a key tile lies inside one mask k-block
          sm.colx[s][lane] = fold16(c0 * COL_MUL);
          sm.colx[s][lane + 32] = fold16((c0 + 32) * COL_MUL);
        }
        if (lane == 0) {
          sm.kmask[s] = (uint64_t)m1 << 32 | m0;
          mbar_arrive_expect_tx(&sm.full[s], 2 * k3a::TILE_BYTES);
          tma_load_3d(sm.k[s], &tk, &sm.full[s], h * DH, k0, b);
          tma_load_3d(sm.v[s], &tv, &sm.full[s], h * DH, k0, b);
        } else {
          mbar_arrive(&sm.full[s]);
        }
      }
    }
  } else {
    // ---- consumers: 64 queries each
    reg_alloc<k3a::CONSUMER_REGS<NCONS>>();
    const int c = wg - 1;
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int q0 = qt * ROWS + c * 64;
    const int qrow0 = q0 + warp * 16 + g;  // rows qrow0 and qrow0 + 8
    const bool dropout = rate > 0.f;
    const int seed = dropout ? *seed_p : 0;
    const float scale = 0.125f;  // 1/sqrt(64)
    const float scale_log2 = scale * LOG2E;
    const int lq_p = (Lq + BQ - 1) / BQ * BQ;
    float lse2[2], dlt[2];  // lse * log2 e and delta of the thread's rows
    uint32_t row_term[2];   // hash row terms; a 64-query tile lies inside one mask q-block (mbq % 64 == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qrow0 + 8 * r;
      const float2 ld = row < Lq ? *reinterpret_cast<const float2*>(stats + (((size_t)b * H + h) * lq_p + row) * 2)
                                 : make_float2(0.f, 0.f);
      lse2[r] = ld.x;
      dlt[r] = ld.y;
      row_term[r] = (uint32_t)(h * mbq + row % mbq) * ROW_MUL;
    }
    float acc[32], s[32], dp[32];
    uint32_t pa[16];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;

    if (n_iter > 0) {
      const uint64_t dQ = sw128_desc(sm.q[c]), dO = sw128_desc(sm.dout[c]);
      // s = q k^T and dp = do v^T (64 queries x 64 keys) of the tile in stage st
      auto issue_sdp = [&](int st) {
        const uint64_t dK = sw128_desc(sm.k[st]), dV = sw128_desc(sm.v[st]);
        fence_regs(s);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_ss<0, 0>(s, dQ + 2 * kk, dK + 2 * kk, kk);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_ss<0, 0>(dp, dO + 2 * kk, dV + 2 * kk, kk);
        wgmma_commit();
      };
      // the keep bits of the tile of iteration it (bit 4j + e: score s[4j + e]), from the folded row
      // terms and the producer's folded column terms
      auto keep_bits = [&](int it) {
        const int k0 = (kt_lo + it) * BK;
        const uint32_t mixmul = block_mix(seed, b, q0 / mbq, k0 / mbk);
        const uint32_t a[2] = {fold16(mixmul ^ row_term[0]), fold16(mixmul ^ row_term[1])};
        const uint32_t* cx = sm.colx[it % k3a::STAGES];
        uint32_t bits = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint2 cc = *reinterpret_cast<const uint2*>(cx + j * 8 + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            bits |= keep_bit_folded(a[e >> 1] ^ ((e & 1) ? cc.y : cc.x), thresh) ? 1u << (4 * j + e) : 0u;
        }
        return bits;
      };

      // A tile with no key to see (kmask 0, the same for every thread) runs
      // no product: its p, and so its ds, would be 0.
      uint32_t keep = 0;
      mbar_wait(&sm.qbar, 0);
      mbar_wait(&sm.full[0], 0);
      if (sm.kmask[0] != 0) {
        issue_sdp(0);
        if (dropout) keep = keep_bits(0);
      }
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      // Each iteration: p and ds of tile it, then dq += ds k of tile it and
      // s, dp of tile it + 1 in flight while the hash of tile it + 1 runs.
      for (int it = 0; it < n_iter; ++it) {
        const int st = it % k3a::STAGES;
        const int k0 = (kt_lo + it) * BK;
        const uint64_t kmask = sm.kmask[st];
        if (kmask != 0) {
          const uint64_t km = kmask >> (2 * t);  // bit 8j + e: key 8j + 2t + e of the tile
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = 4 * j + e, r = e >> 1;
              bool see = (km >> (8 * j + (e & 1))) & 1;
              if (CAUSAL) see = see && in_band<true>(qrow0 + 8 * r, k0 + 8 * j + 2 * t + (e & 1), window);
              const float p = see ? ex2(fmaf(s[i], scale_log2, -lse2[r])) : 0.f;
              float d = dp[i];
              if (dropout) d = (keep >> i) & 1u ? d * keep_scale : 0.f;
              s[i] = p * (d - dlt[r]) * scale;  // ds
            }
          }
          hopper::pack_a(pa, s);
          fence_regs(pa);

          // dq += ds k: ds from registers, k MN-major
          const uint64_t dK = sw128_desc(sm.k[st]);
          wgmma_fence();
#pragma unroll
          for (int kc = 0; kc < 4; ++kc) wgmma_rs<1>(acc, pa + 4 * kc, dK + 128 * kc, 1);
          wgmma_commit();
        }
        if (it + 1 < n_iter) {
          const int nst = (it + 1) % k3a::STAGES;
          mbar_wait(&sm.full[nst], ((it + 1) / k3a::STAGES) & 1);
          if (sm.kmask[nst] != 0) {
            issue_sdp(nst);
            if (dropout) keep = keep_bits(it + 1);
          }
        }
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(s);
        fence_regs(dp);
        mbar_arrive(&sm.empty[st]);
      }
    }

    const int ld = H * DH;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qrow0 + 8 * r;
      if (row >= Lq) continue;
      if (n_split == 1) {
        bf16* drow = dq + ((size_t)b * Lq + row) * ld + h * DH;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(drow + j * 8 + 2 * t) =
              __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      } else {
        float* drow = dq_part + (((size_t)split * B + b) * Lq + row) * ld + h * DH;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(drow + j * 8 + 2 * t) = make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

// The sum of K3a's key-chunk partials in chunk order, rounded to bf16: one
// thread per four columns.
__global__ void __launch_bounds__(256)
flash_dq_merge_kernel(const float* __restrict__ dq_part, bf16* __restrict__ dq, size_t n4, int n_split) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const float4* part = reinterpret_cast<const float4*>(dq_part);
  float4 acc = part[i];
  for (int s = 1; s < n_split; ++s) {
    const float4 x = part[s * n4 + i];
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  __nv_bfloat162 lo = __floats2bfloat162_rn(acc.x, acc.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(acc.z, acc.w);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  reinterpret_cast<uint2*>(dq)[i] = packed;
}

template <int NCONS, bool CAUSAL>
static int launch_dq(const CUtensorMap& tq, const CUtensorMap& tdo, const CUtensorMap& tk, const CUtensorMap& tv,
                     const void* kv_len, const void* kv_valid, const void* seed, const void* stats, void* dq,
                     void* dq_part, int B, int H, int Lq, int Lk, int mbq, int mbk, int window, int n_split, int per,
                     float rate, float keep_scale, unsigned int thresh, cudaStream_t st) {
  auto kernel = &flash_dq_kernel<NCONS, CAUSAL>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, k3a::smem_bytes<NCONS>());
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid((Lq + 64 * NCONS - 1) / (64 * NCONS), H, B * n_split);
  kernel<<<grid, 128 * (NCONS + 1), k3a::smem_bytes<NCONS>(), st>>>(
      tq, tdo, tk, tv, (const int*)kv_len, (const uint8_t*)kv_valid, (const int*)seed, (const float*)stats, (bf16*)dq,
      (float*)dq_part, B, H, Lq, Lk, mbq, mbk, window, n_split, per, rate, keep_scale, thresh);
  return (int)cudaGetLastError();
}

// K3a. A non-causal call (3 consumer warpgroups a block) splits the keys
// into n_split chunks of `per` 64-key tiles (the wrapper's dq_splits) and,
// for n_split > 1, merges the partials from dq_part; a causal call (2
// consumer warpgroups: its band is short) takes n_split 1.
extern "C" int flash_dq_launch(const void* q, const void* k, const void* v, const void* kv_len, const void* kv_valid,
                               const void* seed, const void* dout, const void* stats, void* dq, void* dq_part, int B,
                               int H, int Lq, int Lk, int mbq, int mbk, int causal, int window, int n_split, int per,
                               float rate, float keep_scale, unsigned int thresh, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int n_tiles = (Lk + BK - 1) / BK;
  if (n_split < 1 || per < 1 || (causal && n_split != 1) ||
      (!causal && ((long)n_split * per < n_tiles || (long)(n_split - 1) * per >= n_tiles)) ||
      (n_split > 1 && dq_part == nullptr))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tdo, tk, tv;
  int err = hopper::make_qkv_maps(&tq, &tdo, &tk, &tv, q, dout, k, v, B, Lq, Lk, H * DH);
  if (err) return err;
  auto go = [&](auto launch) {
    return launch(tq, tdo, tk, tv, kv_len, kv_valid, seed, stats, dq, dq_part, B, H, Lq, Lk, mbq, mbk, window,
                  n_split, per, rate, keep_scale, thresh, st);
  };
  err = causal ? go(&launch_dq<2, true>) : go(&launch_dq<3, false>);
  if (err || n_split == 1) return err;
  const size_t n4 = (size_t)B * Lq * H * DH / 4;
  flash_dq_merge_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, st>>>((const float*)dq_part, (bf16*)dq, n4, n_split);
  return (int)cudaGetLastError();
}
