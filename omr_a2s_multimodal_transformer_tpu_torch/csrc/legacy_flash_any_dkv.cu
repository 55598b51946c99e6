// L2c for any float type and head width: dk and dv of the per-head flash
// backward, on the tensor cores.
//
// Replaces, for what the bf16 templates of legacy_flash_dkv.cu do not take
// (float16, float32, heads wider than 128 or misaligned rows),
// tools/legacy_flash/flash_attention_bwd.py _dkv_kernel (:150, pallas_call
// :360). With p = exp(s - lse) on the (query, key) pairs a query sees and
// ds = p * (do v^T - delta): dv = p^T do, dk = ds^T q * scale.
//
// One block of 4 warps per (64-key tile, head, batch row, 64-column chunk of
// dk and dv) walks the query tiles that can see its keys (query_tiles), as
// L2c does, in its transposed frame: each warp owns 16 keys and computes
// s^T = k q^T and dp^T = v do^T, whose accumulators are the A operands of
// dv += p^T do and dk += ds^T q. For D <= 64 the K and V tiles stay in shared
// memory and the Q/dO tiles, with their lse and delta, are double-buffered
// by cp.async; for a wider head each query tile takes one step per
// 64-column chunk of Q, dO, K and V and one for the chunks of Q and dO that
// the output chunk needs (legacy_flash_any_bwd.cuh). dk and dv accumulate in
// f32 registers over the query tiles and are written once: no atomics,
// deterministic. The TPU kernel carried them in VMEM across its sequential
// query-block axis; here that axis is the loop inside the block.
//
// What bounds it on the H100: four products, 8*D FLOP per (query, key) pair
// a query sees; in float32 each runs as three TF32 passes (24*D FLOP at 495
// TFLOP/s; three bf16 passes would meet the float32 tolerance at twice the
// rate). In a windowed causal call at W = 100 a key is seen by at most
// 101 queries: bytes bound it. A head wider than 64 recomputes s and dp
// once per 64-column chunk of dk and dv.
#include "legacy_flash_any_bwd.cuh"

using namespace lfbwd;
using flash::LOG2E;

// shared memory: D <= 64: K, V, then two slots of Q, dO; wider: two slots of
// Q, dO, K, V chunks; then lse*log2(e) and delta of the two slots
template <typename T>
static int dkv_smem(bool resident) {
  return (resident ? 6 : 8) * tile_elems<T>() * (int)sizeof(T) + 4 * BQ * (int)sizeof(float);
}

template <typename T, bool CAUSAL, bool RESIDENT>
__global__ void __launch_bounds__(NT)
lfany_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ kv_len, const uint8_t* __restrict__ kv_valid, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int H, int Lq, int Lk, int D, int window, float scale) {
  constexpr int TE = tile_elems<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nc = RESIDENT ? 1 : (D + CW - 1) / CW;  // RESIDENT: D <= CW
  constexpr int slot_tiles = RESIDENT ? 2 : 4;
  T* res = reinterpret_cast<T*>(smem_raw);   // K, V (resident)
  T* slots = res + (RESIDENT ? 2 : 0) * TE;  // [2][Q, dO (, K, V)]
  float* sLse = reinterpret_cast<float*>(slots + 2 * slot_tiles * TE);  // [2][BQ], log2 domain
  float* sDelta = sLse + 2 * BQ;                                        // [2][BQ]

  const int kt = blockIdx.x, h = blockIdx.y / nc, oc = blockIdx.y % nc, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2;
  const size_t bh = (size_t)b * H + h;
  const int k0 = kt * BK;
  const T* qb = q + bh * Lq * D;
  const T* dob = dout + bh * Lq * D;
  const T* kb = k + bh * Lk * D;
  const T* vbase = v + bh * Lk * D;
  const float* lseb = lse + bh * Lq;
  const float* deltab = delta + bh * Lq;
  const int len = min(kv_len[b], Lk);
  const float scale_log2 = scale * LOG2E;
  int qt_lo, qt_hi;
  legacy::query_tiles<CAUSAL>(k0, (Lq + BQ - 1) / BQ, len, window, qt_lo, qt_hi);
  const int per_tile = RESIDENT ? 1 : nc + 1;  // steps per query tile
  const int n_steps = qt_hi >= qt_lo ? (qt_hi - qt_lo + 1) * per_tile : 0;  // 0: no query sees these keys

  // step: chunk c < nc of Q, dO (and K, V) for s and dp; c == nc: Q's and dO's chunk oc for dk, dv
  auto issue = [&](int step, int slot) {
    const int q0 = (qt_lo + step / per_tile) * BQ, c = step % per_tile;
    T* sl = slots + slot * slot_tiles * TE;
    const int col = c < nc ? c * CW : oc * CW;
    load_chunk<T>(sl, qb, q0, Lq, D, col, tid);
    load_chunk<T>(sl + TE, dob, q0, Lq, D, col, tid);
    if (!RESIDENT && c < nc) {
      load_chunk<T>(sl + 2 * TE, kb, k0, Lk, D, col, tid);
      load_chunk<T>(sl + 3 * TE, vbase, k0, Lk, D, col, tid);
    }
    flash::cp_async_commit();
    if (tid < BQ) {
      const bool in = q0 + tid < Lq;
      sLse[slot * BQ + tid] = in ? lseb[q0 + tid] * LOG2E : 0.f;
      sDelta[slot * BQ + tid] = in ? deltab[q0 + tid] : 0.f;
    }
  };

  if (n_steps > 0) {
    if (RESIDENT) {
      load_chunk<T>(res, kb, k0, Lk, D, 0, tid);
      load_chunk<T>(res + TE, vbase, k0, Lk, D, 0, tid);
    }
    issue(0, 0);  // commits K, V and the first Q/dO chunks as one group
  }

  // keys owned by this thread: r = 0 -> k0+warp*16+g, r = 1 -> +8; an invalid key gets no gradient
  const int krow[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const bool kval[2] = {legacy::key_ok(kv_valid + (size_t)b * Lk, len, krow[0]),
                        legacy::key_ok(kv_valid + (size_t)b * Lk, len, krow[1])};

  float dk_acc[8][4], dv_acc[8][4], st[8][4], dpt[8][4];
  zero(dk_acc);
  zero(dv_acc);
  zero(st);
  zero(dpt);

  for (int sp = 0; sp < n_steps; ++sp) {
    const int slot = sp & 1, c = RESIDENT ? 0 : sp % per_tile;
    if (sp + 1 < n_steps) {
      issue(sp + 1, slot ^ 1);
      flash::cp_async_wait<1>();
    } else {
      flash::cp_async_wait<0>();
    }
    __syncthreads();
    const T* sl = slots + slot * slot_tiles * TE;
    if (c < nc) {
      if (c == 0) {
        zero(st);
        zero(dpt);
      }
      const T* sk = RESIDENT ? res : sl + 2 * TE;
      const T* sv = RESIDENT ? res + TE : sl + 3 * TE;
      // s^T = k q^T and dp^T = v do^T: 16 keys x 64 queries a warp
      chunk_scores<T>(st, dpt, sk, sv, sl, sl + TE, warp * 16, lane);
      if (c == nc - 1) {
        const float* L2 = sLse + slot * BQ;
        const float* Dl = sDelta + slot * BQ;
        const int q0 = (qt_lo + sp / per_tile) * BQ, t = lane & 3;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const int qc = j * 8 + 2 * t + (e & 1);
            const bool see = kval[r] && q0 + qc < Lq && flash::in_band<CAUSAL>(q0 + qc, krow[r], window);
            const float p = see ? flash::ex2(st[j][e] * scale_log2 - L2[qc]) : 0.f;
            st[j][e] = p;
            dpt[j][e] = p * (dpt[j][e] - Dl[qc]);  // ds (the scale is applied to dk)
          }
        }
      }
    }
    if (c == per_tile - 1) {
      chunk_accum<T>(dv_acc, st, sl + TE, lane);  // dv += p^T do
      chunk_accum<T>(dk_acc, dpt, sl, lane);      // dk += ds^T q
    }
    __syncthreads();  // every warp is done with this slot before it is refilled
  }

  store_chunk<T>(dk + bh * Lk * D, dk_acc, scale, k0 + warp * 16, Lk, D, oc * CW, lane);
  store_chunk<T>(dv + bh * Lk * D, dv_acc, 1.f, k0 + warp * 16, Lk, D, oc * CW, lane);
}

template <typename T>
static auto dkv_kernel_for(bool causal, bool resident) {
  return resident ? (causal ? &lfany_dkv_kernel<T, true, true> : &lfany_dkv_kernel<T, false, true>)
                  : (causal ? &lfany_dkv_kernel<T, true, false> : &lfany_dkv_kernel<T, false, false>);
}

template <typename T>
static int dkv_run(const void* q, const void* k, const void* v, const void* kv_len, const void* kv_valid,
                   const void* dout, const void* lse, const void* delta, void* dk, void* dv, int B, int H, int Lq,
                   int Lk, int D, int causal, int window, float scale, void* stream) {
  const int nc = (D + CW - 1) / CW;
  const dim3 grid((Lk + BK - 1) / BK, H * nc, B);
  return launch<T>(dkv_kernel_for<T>(causal, nc == 1), grid, dkv_smem<T>(nc == 1), D, stream, (const T*)q,
                   (const T*)k, (const T*)v, (const int*)kv_len, (const uint8_t*)kv_valid, (const T*)dout,
                   (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, H, Lq, Lk, D, window, scale);
}

// dtype: 0 bf16, 1 f16, 2 f32; D * sizeof(T) and the addresses of q, k, v
// and dout must be multiples of 16 bytes.
extern "C" int lfany_dkv_launch(const void* q, const void* k, const void* v, const void* kv_len,
                                const void* kv_valid, const void* dout, const void* lse, const void* delta, void* dk,
                                void* dv, int dtype, int B, int H, int Lq, int Lk, int D, int causal, int window,
                                float scale, void* stream) {
  return LFANY_DISPATCH(dtype, dkv_run, q, k, v, kv_len, kv_valid, dout, lse, delta, dk, dv, B, H, Lq, Lk, D, causal,
                        window, scale, stream);
}
