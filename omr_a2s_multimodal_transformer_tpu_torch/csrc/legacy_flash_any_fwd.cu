// L1 / L2a for any float type and head width: per-head flash attention
// forward on the tensor cores, with the per-position key mask and lse when
// LSE (L2a).
//
// Replaces, for what the bf16 templates of legacy_flash_fwd.cu do not take
// (float16, float32, heads wider than 128 or misaligned rows),
// tools/legacy_flash/flash_attention.py _kernel (L1, pallas_call :169) and
// tools/legacy_flash/flash_attention_bwd.py _fwd_kernel (L2a, :250), which
// take any float dtype and width and compute in float32. Same function: o =
// softmax(q k^T * scale + mask) v and lse = m + log(sum exp), o = 0 and lse =
// 0 on a row with no key to see (a batch row whose kv_len is 0 runs no key
// tile at all).
//
// One block of 4 warps per (64-query tile, head, batch row) walks the 64-key
// tiles below kv_len and, for a causal call, those of its band
// (legacy::key_tiles), as L1 does, with the key test per score: each key
// tile's test reaches shared memory as a 64-bit mask (two warp ballots).
// Each warp owns 16 queries, with an online softmax in f32 registers (log2
// domain, one ex2 a score). s = q k^T and o += p v are tensor-core products
// (legacy_flash_any_bwd.cuh): bf16 and f16 on m16n8k16 with p rounded to T,
// as L2a rounds to bf16; float32 as three TF32 passes, p split in the
// registers it was computed in, and each key tile's p v summed from zero
// before it is folded into o (o = o * corr + tile). The score tile never
// leaves registers. Width classes (template NR, the 64-column chunks of o a
// block holds in registers, 32 floats a thread each):
// - NR 1 (D <= 64): Q resident in shared memory (16-bit: its A fragments in
//   registers, read once); K and V of a key tile share one cp.async slot,
//   one step a key tile.
// - NR 2, 3 (D <= 128, 192; float32 stops at 2, res_max): Q resident in NR
//   chunks; a key tile takes two steps, K's NR chunks (the scores
//   accumulate over them) and then V's.
// - NR 0 (wider heads): the grid splits o into 64-column chunks, one a
//   block; a key tile takes one step for each chunk of Q and K and one for
//   the V chunk of the block's output, so each output chunk recomputes s.
// The steps' tiles arrive through a ring of three cp.async slots (two in
// float32, whose third would leave one block an SM) with one barrier a
// step: on an H100 the ring took 2-8% off a two-slot double buffer with a
// second barrier a step.
//
// What bounds it on the H100: the two products, 4*D FLOP per (query, key)
// pair a query sees (float32: three TF32 passes of each), against q, o and
// the valid k and v read or written once: at the cross shape ~1268 FLOP a
// byte in bf16, far above the ~295 balance point, so the tensor cores bound
// it; mma.sync reaches a part of their wgmma rate, and the online softmax
// (an ex2 and a few FP32 operations a score) shares the issue slots.
#include "legacy_flash_any_bwd.cuh"

using namespace lfbwd;
using flash::LN2;
using flash::NEG_INF;

// The widest resident class, in 64-column chunks: float32 holds two (at
// three, ptxas spills at 255 registers: o, s and the tile's TF32 sum take
// 160), 16-bit types three (230-235 registers, no spill).
template <typename T>
constexpr int res_max() {
  return sizeof(T) == 4 ? 2 : 3;
}

// chunk tiles of a slot: NR 1 and NR 0 take two (K and V; Q and K), NR 2, 3 take NR
__host__ __device__ constexpr int slot_tiles(int nr) { return nr > 2 ? nr : 2; }

// slots of the ring: three for 16-bit types, two for float32
template <typename T>
__host__ __device__ constexpr int ring() {
  return sizeof(T) == 2 ? 3 : 2;
}

// shared memory: Q's NR resident chunks, the ring's slots, then their key tests (64 bits each)
template <typename T>
static int fwd_smem(int nr) {
  return (nr + ring<T>() * slot_tiles(nr)) * tile_elems<T>() * (int)sizeof(T) + ring<T>() * 8;
}

// Mask a key tile's scores s (k0 its first key, bit i of ok the key test of
// key k0 + i), update
// each row's running max m and sum l, rescale o's accumulators by the change
// of m, and leave p in s. A row that has seen no key yet keeps m = NEG_INF
// and gathers finite junk (p = 1 at every key) that the first seen key's
// corr = 0 clears; a row that never sees one is zeroed at the store.
template <bool CAUSAL, int NO>
__device__ __forceinline__ void online_softmax(float (&s)[8][4], float (&acc)[NO][8][4], float (&m_r)[2],
                                               float (&l_r)[2], uint64_t ok, const int (&qrow)[2], int k0,
                                               int window, float scale_log2, int t) {
  ok >>= 2 * t;  // bit j*8 + (e & 1): the key of score (j, e)
  float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kc = j * 8 + 2 * t + (e & 1);
      const bool see = ((ok >> (j * 8 + (e & 1))) & 1) && flash::in_band<CAUSAL>(qrow[e >> 1], k0 + kc, window);
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
  for (int i = 0; i < NO; ++i) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[i][n][0] *= corr[0];
      acc[i][n][1] *= corr[0];
      acc[i][n][2] *= corr[1];
      acc[i][n][3] *= corr[1];
    }
  }
}

// (NT, 1): ptxas may take up to 255 registers. Held to its default for NT
// alone (128 in float32 D 64, 173 in bf16 D 192), the kernel ran 9% and 7%
// slower at the legacy cross shape on an H100, with no more blocks an SM:
// shared memory allows only two there.
template <typename T, bool CAUSAL, bool LSE, int NR>
__global__ void __launch_bounds__(NT, 1)
lfany_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ kv_len, const uint8_t* __restrict__ kv_valid, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Lq, int Lk, int D, int window, float scale_log2) {
  constexpr int TE = tile_elems<T>(), ST = slot_tiles(NR), NO = NR > 0 ? NR : 1, NS = ring<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* res = reinterpret_cast<T*>(smem_raw);                         // Q's chunks (NR > 0)
  T* slots = res + NR * TE;                                        // [NS][ST]
  uint32_t* sOk = reinterpret_cast<uint32_t*>(slots + NS * ST * TE);  // [NS][2]: the key test of a slot, 64 bits

  const int nc = (D + CW - 1) / CW;  // chunks of a row (NR > 0: nc == NR)
  const int qt = blockIdx.x, b = blockIdx.z;
  const int h = NR > 0 ? blockIdx.y : blockIdx.y / nc, oc = NR > 0 ? 0 : blockIdx.y % nc;  // oc: NR 0's o chunk
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const size_t bh = (size_t)b * H + h;
  const int q0 = qt * BQ;
  const T* qb = q + bh * Lq * D;
  const T* kb = k + bh * Lk * D;
  const T* vb = v + bh * Lk * D;
  const uint8_t* valid_b = LSE ? kv_valid + (size_t)b * Lk : nullptr;
  const int len = min(kv_len[b], Lk);
  int kt_lo, kt_hi;
  legacy::key_tiles<CAUSAL>(q0, len, window, kt_lo, kt_hi);
  const int per_tile = NR == 1 ? 1 : NR > 1 ? 2 : nc + 1;  // steps a key tile
  const int n_steps = kt_hi >= kt_lo ? (kt_hi - kt_lo + 1) * per_tile : 0;  // 0: no key to see; o = 0

  // NR 1: K and V; NR 2, 3: step 0 K's chunks, step 1 V's; NR 0: step c < nc Q's and K's chunk c, step nc
  // V's chunk oc
  auto issue = [&](int step, int slot) {
    const int k0 = (kt_lo + step / per_tile) * BK, c = step % per_tile;
    T* sl = slots + slot * ST * TE;
    if (NR == 1) {
      load_chunk<T>(sl, kb, k0, Lk, D, 0, tid);
      load_chunk<T>(sl + TE, vb, k0, Lk, D, 0, tid);
    } else if (NR > 1) {
#pragma unroll
      for (int i = 0; i < NR; ++i) load_chunk<T>(sl + i * TE, c == 0 ? kb : vb, k0, Lk, D, i * CW, tid);
    } else if (c < nc) {
      load_chunk<T>(sl, qb, q0, Lq, D, c * CW, tid);
      load_chunk<T>(sl + TE, kb, k0, Lk, D, c * CW, tid);
    } else {
      load_chunk<T>(sl, vb, k0, Lk, D, oc * CW, tid);
    }
    flash::cp_async_commit();
    if (warp < 2) {
      const uint32_t bits = __ballot_sync(0xffffffffu, legacy::key_ok(valid_b, len, k0 + tid));
      if (lane == 0) sOk[slot * 2 + warp] = bits;
    }
  };

  if (n_steps > 0) {
#pragma unroll
    for (int i = 0; i < NR; ++i) load_chunk<T>(res + i * TE, qb, q0, Lq, D, i * CW, tid);
  }
  // the first NS - 1 steps, one commit group each (Q joins step 0's); empty groups past the end keep the count
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < n_steps) {
      issue(i, i);
    } else {
      flash::cp_async_commit();
    }
  }

  // rows owned by this thread: r = 0 -> query q0+warp*16+g, r = 1 -> +8
  const int qrow[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float m_r[2] = {NEG_INF, NEG_INF};  // running max, log2 domain; NEG_INF until a key is seen
  float l_r[2] = {0.f, 0.f};
  float acc[NO][8][4], s[8][4];
  uint32_t qf[CW / 16][4];  // 16-bit NR 1: Q's A fragments, read once
#pragma unroll
  for (int i = 0; i < NO; ++i) zero(acc[i]);
  zero(s);

  for (int st = 0; st < n_steps; ++st) {
    const int slot = st % NS, c = st % per_tile;
    flash::cp_async_wait<NS - 2>();  // step st's group has landed
    __syncthreads();  // for every thread's copies, and every warp is done with step st - 1's slot
    if (st + NS - 1 < n_steps) {
      issue(st + NS - 1, (st + NS - 1) % NS);
    } else {
      flash::cp_async_commit();
    }
    const T* sl = slots + slot * ST * TE;
    const uint64_t ok = *reinterpret_cast<const uint64_t*>(sOk + slot * 2);
    const int k0 = (kt_lo + st / per_tile) * BK;
    if (NR == 1) {
      zero(s);
      if constexpr (sizeof(T) == 2) {
        if (st == 0) {
#pragma unroll
          for (int kk = 0; kk < CW / 16; ++kk) {
            legacy::a_frag<CW>(qf[kk], reinterpret_cast<const bf16*>(res), warp * 16, kk, lane);
          }
        }
        chunk_score_frags<T>(s, qf, sl, lane);
      } else {
        chunk_score<T>(s, res, sl, warp * 16, lane);
      }
      online_softmax<CAUSAL, NO>(s, acc, m_r, l_r, ok, qrow, k0, window, scale_log2, t);
      chunk_accum<T>(acc[0], s, sl + TE, lane);
    } else if (NR > 1) {
      if (c == 0) {
        zero(s);
#pragma unroll
        for (int i = 0; i < NR; ++i) chunk_score<T>(s, res + i * TE, sl + i * TE, warp * 16, lane);
        online_softmax<CAUSAL, NO>(s, acc, m_r, l_r, ok, qrow, k0, window, scale_log2, t);
      } else {
#pragma unroll
        for (int i = 0; i < NO; ++i) chunk_accum<T>(acc[i], s, sl + i * TE, lane);
      }
    } else if (c < nc) {
      if (c == 0) zero(s);
      chunk_score<T>(s, sl, sl + TE, warp * 16, lane);
      if (c == nc - 1) online_softmax<CAUSAL, NO>(s, acc, m_r, l_r, ok, qrow, k0, window, scale_log2, t);
    } else {
      chunk_accum<T>(acc[0], s, sl, lane);
    }
  }

  const bool seen[2] = {m_r[0] > NEG_INF, m_r[1] > NEG_INF};  // a row that saw no key keeps o = 0, lse = 0
  const float inv[2] = {seen[0] ? 1.f / l_r[0] : 0.f, seen[1] ? 1.f / l_r[1] : 0.f};
#pragma unroll
  for (int i = 0; i < NO; ++i) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[i][n][0] *= inv[0];
      acc[i][n][1] *= inv[0];
      acc[i][n][2] *= inv[1];
      acc[i][n][3] *= inv[1];
    }
    store_chunk<T>(o + bh * Lq * D, acc[i], 1.f, q0 + warp * 16, Lq, D, (NR > 0 ? i : oc) * CW, lane);
  }
  if (LSE && oc == 0 && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qrow[r] < Lq) lse[bh * Lq + qrow[r]] = seen[r] ? m_r[r] * LN2 + logf(l_r[r]) : 0.f;
    }
  }
}

template <typename T, bool LSE, int NR>
static int fwd_launch(dim3 grid, const T* q, const T* k, const T* v, const int* kv_len, const uint8_t* kv_valid,
                      T* o, float* lse, int H, int Lq, int Lk, int D, bool causal, int window, float scale_log2,
                      void* stream) {
  auto kernel = causal ? &lfany_fwd_kernel<T, true, LSE, NR> : &lfany_fwd_kernel<T, false, LSE, NR>;
  return launch<T>(kernel, grid, fwd_smem<T>(NR), D, stream, q, k, v, kv_len, kv_valid, o, lse, H, Lq, Lk, D,
                   window, scale_log2);
}

template <typename T, bool LSE>
static int fwd_classes(const T* q, const T* k, const T* v, const int* kv_len, const uint8_t* kv_valid, T* o,
                       float* lse, int B, int H, int Lq, int Lk, int D, bool causal, int window, float scale_log2,
                       void* stream) {
  const int nc = (D + CW - 1) / CW;
  const int nr = nc <= res_max<T>() ? nc : 0;
  const dim3 grid((Lq + BQ - 1) / BQ, H * (nr > 0 ? 1 : nc), B);
  auto run = nr == 1 ? &fwd_launch<T, LSE, 1> : nr == 2 ? &fwd_launch<T, LSE, 2> : &fwd_launch<T, LSE, 0>;
  if constexpr (res_max<T>() == 3) {
    if (nr == 3) run = &fwd_launch<T, LSE, 3>;
  }
  return run(grid, q, k, v, kv_len, kv_valid, o, lse, H, Lq, Lk, D, causal, window, scale_log2, stream);
}

template <typename T>
static int fwd_run(const void* q, const void* k, const void* v, const void* kv_len, const void* kv_valid, void* o,
                   void* lse, int B, int H, int Lq, int Lk, int D, int causal, int window, int with_lse, float scale,
                   void* stream) {
  auto run = with_lse ? &fwd_classes<T, true> : &fwd_classes<T, false>;
  return run((const T*)q, (const T*)k, (const T*)v, (const int*)kv_len, with_lse ? (const uint8_t*)kv_valid : nullptr,
             (T*)o, with_lse ? (float*)lse : nullptr, B, H, Lq, Lk, D, causal != 0, window, scale * flash::LOG2E,
             stream);
}

// dtype: 0 bf16, 1 f16, 2 f32. with_lse = 0: L1 (kv_valid and lse ignored); 1: L2a. D * sizeof(T) and the
// addresses of q, k and v must be multiples of 16 bytes.
extern "C" int lfany_fwd_launch(const void* q, const void* k, const void* v, const void* kv_len,
                                const void* kv_valid, void* o, void* lse, int dtype, int B, int H, int Lq, int Lk,
                                int D, int causal, int window, int with_lse, float scale, void* stream) {
  if (D <= 0 || (with_lse && (kv_valid == nullptr || lse == nullptr))) return (int)cudaErrorInvalidValue;
  return LFANY_DISPATCH(dtype, fwd_run, q, k, v, kv_len, kv_valid, o, lse, B, H, Lq, Lk, D, causal, window, with_lse,
                        scale, stream);
}
