// L2b for any float type and head width: dq of the per-head flash backward,
// on the tensor cores.
//
// Replaces, for what the bf16 templates of legacy_flash_dq.cu do not take
// (float16, float32, heads wider than 128 or misaligned rows),
// tools/legacy_flash/flash_attention_bwd.py _dq_kernel (:109, pallas_call
// :328). With p = exp(s - lse) on the keys a query sees (0 elsewhere) and
// the caller's delta = rowsum(do * o): ds = p * (do v^T - delta), dq = ds k *
// scale.
//
// One block of 4 warps per (64-query tile, head, batch row, 64-column chunk
// of dq) walks the key tiles below kv_len and in its causal band
// (key_tiles), as L2b does; each warp owns 16 queries. For D <= 64 the Q and
// dO tiles stay in shared memory and the K/V tiles are double-buffered by
// cp.async; for a wider head each key tile takes one step per 64-column
// chunk of Q, dO, K and V (s and dp accumulate over them) and one for the
// chunk of K that dq's chunk needs (legacy_flash_any_bwd.cuh). s and dp are
// tensor-core products with f32 accumulators; ds stays in their registers
// as the A operand of dq += ds k. dq accumulates in f32 registers over the
// band and is written once: no atomics, deterministic. The TPU kernel
// carried dq in VMEM across its sequential key-block axis; here that axis is
// the loop inside the block.
//
// What bounds it on the H100: three products, 6*D FLOP per (query, key)
// pair a query sees, far above the balance point at the cross shape. In
// float32 the tensor cores run each product three times (TF32 big/small
// terms, 18*D FLOP at 495 TFLOP/s); three bf16 passes would also meet the
// float32 tolerance at twice that rate (probe_legacy_any.py). A head wider
// than 64 recomputes s and dp once per 64-column chunk of dq.
#include "legacy_flash_any_bwd.cuh"

using namespace lfbwd;
using flash::LOG2E;

// shared memory: D <= 64: Q, dO, then two slots of K, V; wider: two slots of
// K, V, Q, dO chunks; then the key test of the two slots
template <typename T>
static int dq_smem(bool resident) {
  return (resident ? 6 : 8) * tile_elems<T>() * (int)sizeof(T) + 2 * BK;
}

template <typename T, bool CAUSAL, bool RESIDENT>
__global__ void __launch_bounds__(NT)
lfany_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const int* __restrict__ kv_len, const uint8_t* __restrict__ kv_valid, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dq, int H, int Lq,
                int Lk, int D, int window, float scale) {
  constexpr int TE = tile_elems<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nc = RESIDENT ? 1 : (D + CW - 1) / CW;  // RESIDENT: D <= CW
  constexpr int slot_tiles = RESIDENT ? 2 : 4;
  T* res = reinterpret_cast<T*>(smem_raw);           // Q, dO (resident)
  T* slots = res + (RESIDENT ? 2 : 0) * TE;          // [2][K, V (, Q, dO)]
  uint8_t* sOk = reinterpret_cast<uint8_t*>(slots + 2 * slot_tiles * TE);  // [2][BK]

  const int qt = blockIdx.x, h = blockIdx.y / nc, oc = blockIdx.y % nc, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2;
  const size_t bh = (size_t)b * H + h;
  const int q0 = qt * BQ;
  const T* qb = q + bh * Lq * D;
  const T* dob = dout + bh * Lq * D;
  const T* kb = k + bh * Lk * D;
  const T* vbase = v + bh * Lk * D;
  const uint8_t* valid_b = kv_valid + (size_t)b * Lk;
  const int len = min(kv_len[b], Lk);
  const float scale_log2 = scale * LOG2E;
  int kt_lo, kt_hi;
  legacy::key_tiles<CAUSAL>(q0, len, window, kt_lo, kt_hi);
  const int per_tile = RESIDENT ? 1 : nc + 1;  // steps per key tile
  const int n_steps = kt_hi >= kt_lo ? (kt_hi - kt_lo + 1) * per_tile : 0;  // 0: no key to see; dq = 0

  // step: chunk c < nc of K, V (and Q, dO) for s and dp; c == nc: K's chunk oc for dq
  auto issue = [&](int step, int slot) {
    const int k0 = (kt_lo + step / per_tile) * BK, c = step % per_tile;
    T* sl = slots + slot * slot_tiles * TE;
    if (c < nc) {
      load_chunk<T>(sl, kb, k0, Lk, D, c * CW, tid);
      load_chunk<T>(sl + TE, vbase, k0, Lk, D, c * CW, tid);
      if (!RESIDENT) {
        load_chunk<T>(sl + 2 * TE, qb, q0, Lq, D, c * CW, tid);
        load_chunk<T>(sl + 3 * TE, dob, q0, Lq, D, c * CW, tid);
      }
    } else {
      load_chunk<T>(sl, kb, k0, Lk, D, oc * CW, tid);
    }
    flash::cp_async_commit();
    if (tid < BK) sOk[slot * BK + tid] = legacy::key_ok(valid_b, len, k0 + tid) ? 1 : 0;
  };

  if (n_steps > 0) {
    if (RESIDENT) {
      load_chunk<T>(res, qb, q0, Lq, D, 0, tid);
      load_chunk<T>(res + TE, dob, q0, Lq, D, 0, tid);
    }
    issue(0, 0);  // commits Q, dO and the first K/V chunks as one group
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
  float acc[8][4], s[8][4], dp[8][4];
  zero(acc);
  zero(s);
  zero(dp);

  for (int st = 0; st < n_steps; ++st) {
    const int slot = st & 1, c = RESIDENT ? 0 : st % per_tile;
    if (st + 1 < n_steps) {
      issue(st + 1, slot ^ 1);
      flash::cp_async_wait<1>();
    } else {
      flash::cp_async_wait<0>();
    }
    __syncthreads();
    const T* sl = slots + slot * slot_tiles * TE;
    if (c < nc) {
      if (c == 0) {
        zero(s);
        zero(dp);
      }
      const T* sq = RESIDENT ? res : sl + 2 * TE;
      const T* sdo = RESIDENT ? res + TE : sl + 3 * TE;
      chunk_scores<T>(s, dp, sq, sdo, sl, sl + TE, warp * 16, lane);
      if (c == nc - 1) {
        const uint8_t* ok = sOk + slot * BK;
        const int k0 = (kt_lo + st / per_tile) * BK, t = lane & 3;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const int kc = j * 8 + 2 * t + (e & 1);
            const bool see = ok[kc] && qrow[r] < Lq && flash::in_band<CAUSAL>(qrow[r], k0 + kc, window);
            const float p = see ? flash::ex2(s[j][e] * scale_log2 - lse2[r]) : 0.f;
            s[j][e] = p * (dp[j][e] - dlt[r]);  // ds (the scale is applied to dq)
          }
        }
      }
    }
    if (c == per_tile - 1) chunk_accum<T>(acc, s, sl, lane);  // dq += ds k
    __syncthreads();  // every warp is done with this slot before it is refilled
  }

  store_chunk<T>(dq + bh * Lq * D, acc, scale, q0 + warp * 16, Lq, D, oc * CW, lane);
}

template <typename T>
static auto dq_kernel_for(bool causal, bool resident) {
  return resident ? (causal ? &lfany_dq_kernel<T, true, true> : &lfany_dq_kernel<T, false, true>)
                  : (causal ? &lfany_dq_kernel<T, true, false> : &lfany_dq_kernel<T, false, false>);
}

template <typename T>
static int dq_run(const void* q, const void* k, const void* v, const void* kv_len, const void* kv_valid,
                  const void* dout, const void* lse, const void* delta, void* dq, int B, int H, int Lq, int Lk, int D,
                  int causal, int window, float scale, void* stream) {
  const int nc = (D + CW - 1) / CW;
  const dim3 grid((Lq + BQ - 1) / BQ, H * nc, B);
  return launch<T>(dq_kernel_for<T>(causal, nc == 1), grid, dq_smem<T>(nc == 1), D, stream, (const T*)q,
                   (const T*)k, (const T*)v, (const int*)kv_len, (const uint8_t*)kv_valid, (const T*)dout,
                   (const float*)lse, (const float*)delta, (T*)dq, H, Lq, Lk, D, window, scale);
}

// dtype: 0 bf16, 1 f16, 2 f32; D * sizeof(T) and the addresses of q, k, v
// and dout must be multiples of 16 bytes.
extern "C" int lfany_dq_launch(const void* q, const void* k, const void* v, const void* kv_len, const void* kv_valid,
                               const void* dout, const void* lse, const void* delta, void* dq, int dtype, int B,
                               int H, int Lq, int Lk, int D, int causal, int window, float scale, void* stream) {
  return LFANY_DISPATCH(dtype, dq_run, q, k, v, kv_len, kv_valid, dout, lse, delta, dq, B, H, Lq, Lk, D, causal,
                        window, scale, stream);
}
