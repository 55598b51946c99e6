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
// the row; its comment intends 0). p is rounded to bf16 before the PV
// product (the JAX kernel keeps it in f32).
//
// What bounds it on the H100: the two products are 4*D FLOP per (query,
// key) pair a query sees against 2*D*2 bytes of k and v per key, read once
// per (b, h): at the cross shape (1268 queries a key) ~1268 FLOP/byte, far
// above the ~295 balance point, so tensor-core FLOPs bound it; the CUDA
// cores (an exp and the online-softmax update per score) set the pace
// first. In a windowed causal call at W = 100 a query sees at most 101
// keys against ~4*D*2 bytes of q, k, v and o per query: bytes bound it,
// and launch latency and the 2-3 key tiles each query tile walks set its
// time.
//
// The design is K1's block (flash_fwd.cuh) on the per-head layout, with no
// dropout (the hash is compiled out) and the caller's scale: a producer
// warp feeding a 4-stage TMA ring of 64-key K and V tiles to consumer
// warpgroups of 64 queries, both products on wgmma, online softmax in the
// log2 domain; only the key tiles below kv_len and, for a causal call, of
// the block's band are walked, and a key tile with no key to see is neither
// loaded nor multiplied. [B, H, L, D] tensors are read through maps of (D
// columns, L rows, B*H), whose zero fill gives the columns past D and the
// rows past L; heads come in two width classes:
// - D <= 64: one 64-column box a row, 3 consumer warpgroups, as K1 (on the
//   band too: a consumer skips the tiles outside its queries' band, and 3
//   were 3-7% faster than 2 at the paper's window on the H100);
// - 64 < D <= 128: two boxes a row, o in two 64 x 64 accumulators, 2
//   consumer warpgroups (240 registers a thread; 3, at 160 and 183,368 B of
//   shared memory, were 2-12% slower at the cross shape on the H100).
// A non-causal call walks its key tiles in n_split chunks of `per` (the
// wrapper's legacy_fwd_splits), each writing an f32 partial (o, lse) that a
// second kernel merges by lse in chunk order; a causal call walks its band
// in one. No atomics: o and lse are bitwise deterministic. L1 writes no
// lse; with more than one chunk its partial lse is scratch.
#include "flash_fwd.cuh"

using namespace flash;

// grid (ceil(Lq / (64 NCONS)), H, B * n_split); NB boxes of 64 columns a row.
// L1: kv_len and the causal band only.
template <int NCONS, bool CAUSAL, int NB>
__global__ void __launch_bounds__(128 * (NCONS + 1), 1)
lf_fwd_chunk(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, const int* __restrict__ kv_len, bf16* __restrict__ o,
             float* __restrict__ o_part, float* __restrict__ lse_part, int B, int H, int Lq, int Lk, int D, int window,
             int n_split, int per, float scale) {
  k1::fwd_block<NCONS, CAUSAL, true, NB, false, false>(k1::grid_block(n_split), &tq, &tk, &tv, kv_len, nullptr,
                                                       nullptr, o, nullptr, o_part, lse_part, B, H, Lq, Lk, D, BQ, BK,
                                                       window, n_split, per, scale, 0.f, 1.f, 0u);
}

// L2a: kv_valid as well, and lse.
template <int NCONS, bool CAUSAL, int NB>
__global__ void __launch_bounds__(128 * (NCONS + 1), 1)
lf_fwd_lse_chunk(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const int* __restrict__ kv_len,
                 const uint8_t* __restrict__ kv_valid, bf16* __restrict__ o, float* __restrict__ lse,
                 float* __restrict__ o_part, float* __restrict__ lse_part, int B, int H, int Lq, int Lk, int D,
                 int window, int n_split, int per, float scale) {
  k1::fwd_block<NCONS, CAUSAL, true, NB, false, true>(k1::grid_block(n_split), &tq, &tk, &tv, kv_len, kv_valid,
                                                      nullptr, o, lse, o_part, lse_part, B, H, Lq, Lk, D, BQ, BK,
                                                      window, n_split, per, scale, 0.f, 1.f, 0u);
}

// The merges of L1's and L2a's key chunks by lse, in chunk order (L1 writes
// no lse); each its own symbol, so that a trace tells L1 and L2a apart.
__global__ void __launch_bounds__(k1::MERGE_THREADS)
lf_fwd_chunk_merge(const float* __restrict__ o_part, const float* __restrict__ lse_part, bf16* __restrict__ o,
                   size_t rows, int D, int n_split) {
  k1::merge_rows(o_part, lse_part, o, nullptr, rows, D, n_split);
}

__global__ void __launch_bounds__(k1::MERGE_THREADS)
lf_fwd_lse_chunk_merge(const float* __restrict__ o_part, const float* __restrict__ lse_part, bf16* __restrict__ o,
                       float* __restrict__ lse, size_t rows, int D, int n_split) {
  k1::merge_rows(o_part, lse_part, o, lse, rows, D, n_split);
}

struct FwdArgs {
  const CUtensorMap *tq, *tk, *tv;
  const void *kv_len, *kv_valid;
  void *o, *lse, *o_part, *lse_part;
  int B, H, Lq, Lk, D, window, n_split, per;
  float scale;
  cudaStream_t st;
};

template <int NCONS, bool CAUSAL, int NB>
static int launch_fwd(const FwdArgs& a, bool with_lse) {
  constexpr int smem = k1::smem_bytes<NCONS, NB>();
  auto l1 = &lf_fwd_chunk<NCONS, CAUSAL, NB>;
  auto l2 = &lf_fwd_lse_chunk<NCONS, CAUSAL, NB>;
  const cudaError_t e = with_lse ? cudaFuncSetAttribute(l2, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
                                 : cudaFuncSetAttribute(l1, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.Lq + 64 * NCONS - 1) / (64 * NCONS), a.H, a.B * a.n_split);
  if (with_lse)
    l2<<<grid, 128 * (NCONS + 1), smem, a.st>>>(*a.tq, *a.tk, *a.tv, (const int*)a.kv_len, (const uint8_t*)a.kv_valid,
                                                (bf16*)a.o, (float*)a.lse, (float*)a.o_part, (float*)a.lse_part, a.B,
                                                a.H, a.Lq, a.Lk, a.D, a.window, a.n_split, a.per, a.scale);
  else
    l1<<<grid, 128 * (NCONS + 1), smem, a.st>>>(*a.tq, *a.tk, *a.tv, (const int*)a.kv_len, (bf16*)a.o,
                                                (float*)a.o_part, (float*)a.lse_part, a.B, a.H, a.Lq, a.Lk, a.D,
                                                a.window, a.n_split, a.per, a.scale);
  return (int)cudaGetLastError();
}

// with_lse = 0: L1 (kv_valid and lse are ignored); 1: L2a. [B, H, L, D] bf16
// with D % 8 == 0, D <= 128 and 16-byte aligned bases. A non-causal call
// splits the key tiles into n_split chunks of `per` and, for n_split > 1,
// merges the partials from o_part ([n_split, B, H, Lq, D] f32) and lse_part
// ([n_split, B, H, Lq] f32); a causal call takes n_split 1. A block holds
// 3 consumer warpgroups for D <= 64 and 2 for D > 64: this switch must match
// LEGACY_FWD_CONSUMERS in tools/legacy_flash/flash_attention.py, which sizes
// the key chunks for these blocks (chip_smoke.py and the card tests check
// the launched blocks against it).
extern "C" int lf_fwd_launch(const void* q, const void* k, const void* v, const void* kv_len, const void* kv_valid,
                             void* o, void* lse, void* o_part, void* lse_part, int B, int H, int Lq, int Lk, int D,
                             int causal, int window, int with_lse, int n_split, int per, float scale, void* stream) {
  if (D <= 0 || D > 128 || D % 8 || (with_lse && (kv_valid == nullptr || lse == nullptr)) ||
      !k1::valid_split(Lk, causal, n_split, per, o_part, lse_part))
    return (int)cudaErrorInvalidValue;
  const bool wide = D > 64, l2 = with_lse != 0;
  int (*launch)(const FwdArgs&, bool) = wide ? (causal ? &launch_fwd<2, true, 2> : &launch_fwd<2, false, 2>)
                                             : (causal ? &launch_fwd<3, true, 1> : &launch_fwd<3, false, 1>);
  CUtensorMap tq, tk, tv;
  int err = hopper::make_map_bf16(&tq, q, B * H, Lq, D, 64);
  if (!err) err = hopper::make_map_bf16(&tk, k, B * H, Lk, D, 64);
  if (!err) err = hopper::make_map_bf16(&tv, v, B * H, Lk, D, 64);
  if (err) return err;
  const FwdArgs a{&tq, &tk, &tv, kv_len, kv_valid, o, lse, o_part, lse_part, B, H, Lq, Lk, D, window, n_split, per,
                  scale, (cudaStream_t)stream};
  err = launch(a, l2);
  if (err || n_split == 1) return err;
  const size_t rows = (size_t)B * H * Lq, n = rows * (D / 4);
  const unsigned blocks = (unsigned)((n + k1::MERGE_THREADS - 1) / k1::MERGE_THREADS);
  if (l2)
    lf_fwd_lse_chunk_merge<<<blocks, k1::MERGE_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)o_part, (const float*)lse_part, (bf16*)o, (float*)lse, rows, D, n_split);
  else
    lf_fwd_chunk_merge<<<blocks, k1::MERGE_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)o_part, (const float*)lse_part, (bf16*)o, rows, D, n_split);
  return (int)cudaGetLastError();
}
