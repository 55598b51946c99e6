// The tensor-core pieces of the any-dtype legacy flash kernels
// (legacy_flash_any_fwd.cu: L1 / L2a; legacy_flash_any_dq.cu: dq;
// legacy_flash_any_dkv.cu: dk and dv; the header is named for the backward,
// which it served first): the route of tools/legacy_flash that the bf16
// templates (legacy_flash_{fwd,dq,dkv}.cu: bf16, D <= 128, 16-byte rows) do
// not take, that is float16, float32, heads of any width and rows that are
// not 16-byte aligned.
//
// Layout as there: q/o/do/dq [B, H, Lq, D] and k/v/dk/dv [B, H, Lk, D] of one
// type T (bf16, f16 or f32), contiguous; lse and delta [B, H, Lq] f32. D is a
// runtime width. A block owns a 64-row tile (queries for the forward and dq,
// keys for dk/dv) and walks the 64-row tiles of the other side; every tile
// reaches shared memory in chunks of 64 columns (CW), by cp.async copies of
// 16 bytes (the wrappers pad or copy operands whose rows or addresses are
// not 16-byte aligned). Columns past D and rows past the end are
// zero-filled, so they add 0 to every product. How many chunks a block
// keeps resident, and how the grid splits a wide output into 64-column
// chunks (recomputing the scores for each), is each kernel's choice: the
// register file holds a few chunks' accumulators.
//
// Products (each warp owns 16 rows of the block's tile; 16 x 64 scores):
// - bf16, f16: mma.sync m16n8k16 with f32 accumulation, fragments by
//   ldmatrix from rows of 72 elements (the bf16 templates' layout). p and
//   ds are rounded to T before their products, as L2a-L2c round to bf16.
// - f32: three TF32 passes of mma.sync m16n8k8 (a = big + small, a b =
//   big big + big small + small big, as PyTorch's memory-efficient
//   attention does for float32, with CUTLASS's split: big truncated, small
//   rounded half up), split as the fragments are read, from rows of 68
//   floats (every fragment load of a warp hits 32 distinct banks). The
//   accumulator of a 16 x 8 score tile holds keys 2t and 2t+1 of its row,
//   where the k8 A fragment wants t and t + 4: the second product relabels
//   its k index (A column t is key 2t, t + 4 is 2t + 1) and reads the B
//   rows to match, so p and ds feed the tensor cores from the registers
//   they were computed in. The tensor cores do not round their f32 sums to
//   nearest, so a tile's product is summed from zero and then added to the
//   running sum (summed straight into it over the 199 key tiles of the
//   cross shape, dq's error on an H100 reached 9.5e-5 x max |dq|, against a
//   float32 tolerance of 1e-4).
#pragma once

#include "legacy_flash_any.cuh"
#include "legacy_flash_common.cuh"

namespace lfbwd {

using flash::bf16;
using flash::BK;
using flash::BQ;
using flash::NT;

constexpr int CW = 64;  // columns of a chunk

// Shared-memory row stride (elements) of a chunk tile of T, and its size.
template <typename T>
__host__ __device__ constexpr int stride() {
  return sizeof(T) == 4 ? CW + 4 : CW + 8;
}

template <typename T>
__host__ __device__ constexpr int tile_elems() {
  return 64 * stride<T>();
}

// Start copying rows [row0, row0 + 64), columns [c0, c0 + CW) of a
// row-major [n_rows, D] matrix into a chunk tile, by 16-byte copies (16
// divides D * sizeof(T) and the address of g); zero-fill outside.
template <typename T>
__device__ __forceinline__ void load_chunk(T* sm, const T* g, int row0, int n_rows, int D, int c0, int tid) {
  constexpr int VE = 16 / (int)sizeof(T), NV = CW / VE, S = stride<T>();
  for (int i = tid; i < 64 * NV; i += NT) {
    const int r = i / NV, c = (i % NV) * VE;
    const bool in = row0 + r < n_rows && c0 + c < D;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(flash::smem_addr(sm + r * S + c)),
                 "l"(in ? g + (size_t)(row0 + r) * D + c0 + c : g), "r"(in ? 16 : 0));
  }
}

// ------------------------------------------------------------ 16-bit types

template <typename T>
__device__ __forceinline__ void mma_k16(float* c, const uint32_t* a, const uint32_t* b);

template <>
__device__ __forceinline__ void mma_k16<bf16>(float* c, const uint32_t* a, const uint32_t* b) {
  flash::mma16816(c, a, b);
}

template <>
__device__ __forceinline__ void mma_k16<__half>(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack2<bf16>(float lo, float hi) {
  return flash::pack_f2(lo, hi);
}

template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------------ float32

// x = big + small to TF32 precision: big keeps the top 19 bits, small
// (exact in f32) is rounded half up by adding half a TF32 ulp; the tensor
// cores read the top 19 bits of each.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in three TF32 passes, the small terms first.
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* ab, const uint32_t* as, const uint32_t* bb,
                                           const uint32_t* bs) {
  mma_tf32(c, as, bb);
  mma_tf32(c, ab, bs);
  mma_tf32(c, ab, bb);
}

// ------------------------------------------------------------ the products

// s[j] += A B^T over the 64 columns of a chunk (zero past D): A is the 16
// rows from r0 of a chunk tile, B the 64 rows of another, in 8-row n tiles j.
// The 16-bit s[j] += A B^T of chunk_score with A's four fragments given
// (fa[kk]: columns kk*16 .. kk*16+15, legacy::a_frag), as a kernel that
// keeps them in registers across key tiles calls it.
template <typename T>
__device__ __forceinline__ void chunk_score_frags(float (&s)[8][4], const uint32_t (&fa)[CW / 16][4], const T* B,
                                                  int lane) {
  const bf16* b = reinterpret_cast<const bf16*>(B);
#pragma unroll
  for (int c2 = 0; c2 < CW / 32; ++c2) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t fb[2][2];
      legacy::bt_frags<CW>(fb, b, j * 8, c2 * 32, lane);
#pragma unroll
      for (int i = 0; i < 2; ++i) mma_k16<T>(s[j], fa[2 * c2 + i], fb[i]);
    }
  }
}

template <typename T>
__device__ __forceinline__ void chunk_score(float (&s)[8][4], const T* A, const T* B, int r0, int lane) {
  if constexpr (sizeof(T) == 2) {
    uint32_t fa[CW / 16][4];
#pragma unroll
    for (int kk = 0; kk < CW / 16; ++kk) legacy::a_frag<CW>(fa[kk], reinterpret_cast<const bf16*>(A), r0, kk, lane);
    chunk_score_frags<T>(s, fa, B, lane);
  } else {
    constexpr int S = stride<float>();
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < CW / 8; ++kk) {
      // A fragment (m16n8k8): (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
      const float* pa = A + (r0 + g) * S + kk * 8 + t;
      uint32_t ab[4], as[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(pa[(e & 1) * 8 * S + (e >> 1) * 4], ab[e], as[e]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // B fragment of X^T: (k t, n g) and (k t + 4, n g) = X[j*8 + g][t], X[j*8 + g][t + 4]
        const float* pb = B + (j * 8 + g) * S + kk * 8 + t;
        uint32_t bb[2], bs[2];
        split_tf32(pb[0], bb[0], bs[0]);
        split_tf32(pb[4], bb[1], bs[1]);
        mma_3xtf32(s[j], ab, as, bb, bs);
      }
    }
  }
}

// s[j] += A1 B1^T and dp[j] += A2 B2^T over the 64 columns of a chunk
// (zero past D): A1, A2 are the 16 rows from r0 of a chunk tile, B1, B2 the
// 64 rows of another, in 8-row n tiles j. The backward's two score
// products, interleaved; chunk_score is one of them (written as two
// calls of it, ptxas spilled in two of dq's twelve instances and four of
// dk/dv's twelve, against one of dq's interleaved).
template <typename T>
__device__ __forceinline__ void chunk_scores(float (&s)[8][4], float (&dp)[8][4], const T* A1, const T* A2,
                                             const T* B1, const T* B2, int r0, int lane) {
  if constexpr (sizeof(T) == 2) {
    const bf16 *a1 = reinterpret_cast<const bf16*>(A1), *a2 = reinterpret_cast<const bf16*>(A2);
    const bf16 *b1 = reinterpret_cast<const bf16*>(B1), *b2 = reinterpret_cast<const bf16*>(B2);
#pragma unroll
    for (int c2 = 0; c2 < CW / 32; ++c2) {
      uint32_t fa1[2][4], fa2[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        legacy::a_frag<CW>(fa1[i], a1, r0, 2 * c2 + i, lane);
        legacy::a_frag<CW>(fa2[i], a2, r0, 2 * c2 + i, lane);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t fb1[2][2], fb2[2][2];
        legacy::bt_frags<CW>(fb1, b1, j * 8, c2 * 32, lane);
        legacy::bt_frags<CW>(fb2, b2, j * 8, c2 * 32, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_k16<T>(s[j], fa1[i], fb1[i]);
          mma_k16<T>(dp[j], fa2[i], fb2[i]);
        }
      }
    }
  } else {
    constexpr int S = stride<float>();
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < CW / 8; ++kk) {
      // A fragment (m16n8k8): (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
      const float* pa1 = A1 + (r0 + g) * S + kk * 8 + t;
      const float* pa2 = A2 + (r0 + g) * S + kk * 8 + t;
      uint32_t a1b[4], a1s[4], a2b[4], a2s[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int off = (e & 1) * 8 * S + (e >> 1) * 4;
        split_tf32(pa1[off], a1b[e], a1s[e]);
        split_tf32(pa2[off], a2b[e], a2s[e]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // B fragment of X^T: (k t, n g) and (k t + 4, n g) = X[j*8 + g][t], X[j*8 + g][t + 4]
        const float* pb1 = B1 + (j * 8 + g) * S + kk * 8 + t;
        const float* pb2 = B2 + (j * 8 + g) * S + kk * 8 + t;
        uint32_t b1b[2], b1s[2], b2b[2], b2s[2];
        split_tf32(pb1[0], b1b[0], b1s[0]);
        split_tf32(pb1[4], b1b[1], b1s[1]);
        split_tf32(pb2[0], b2b[0], b2s[0]);
        split_tf32(pb2[4], b2b[1], b2s[1]);
        mma_3xtf32(s[j], a1b, a1s, b1b, b1s);
        mma_3xtf32(dp[j], a2b, a2s, b2b, b2s);
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&x)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.f;
}

// acc += P X: P is 16 x 64 in the accumulator layout of chunk_score (P[j]
// holds columns j*8 .. j*8+7), rounded to T (16-bit) or split for TF32
// here; X is a 64-row chunk tile.
template <typename T>
__device__ __forceinline__ void chunk_accum(float (&acc)[8][4], const float (&P)[8][4], const T* X, int lane) {
  if constexpr (sizeof(T) == 2) {
    const bf16* x = reinterpret_cast<const bf16*>(X);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      // the accumulators of n tiles 2kc, 2kc+1 are the A fragment of the 16-column k chunk kc
      const uint32_t a[4] = {pack2<T>(P[2 * kc][0], P[2 * kc][1]), pack2<T>(P[2 * kc][2], P[2 * kc][3]),
                             pack2<T>(P[2 * kc + 1][0], P[2 * kc + 1][1]),
                             pack2<T>(P[2 * kc + 1][2], P[2 * kc + 1][3])};
#pragma unroll
      for (int n = 0; n < 8; n += 2) {
        uint32_t fb[2][2];
        legacy::b_frags<CW>(fb, x, kc * 16, n, lane);
        mma_k16<T>(acc[n], a, fb[0]);
        mma_k16<T>(acc[n + 1], a, fb[1]);
      }
    }
  } else {
    constexpr int S = stride<float>();
    const int g = lane >> 2, t = lane & 3;
    float tile[8][4];  // this tile's product, summed from zero (see the note at the top)
    zero(tile);
#pragma unroll
    for (int kc = 0; kc < 8; ++kc) {
      // A column t is key 2t (accumulator element 0 / 2), column t + 4 is key 2t + 1 (element 1 / 3)
      uint32_t pb[4], ps[4];
      split_tf32(P[kc][0], pb[0], ps[0]);
      split_tf32(P[kc][2], pb[1], ps[1]);
      split_tf32(P[kc][1], pb[2], ps[2]);
      split_tf32(P[kc][3], pb[3], ps[3]);
      const float* px = X + (kc * 8 + 2 * t) * S + g;  // B rows: keys 2t and 2t + 1, column g of tile n
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t bb[2], bs[2];
        split_tf32(px[n * 8], bb[0], bs[0]);
        split_tf32(px[S + n * 8], bb[1], bs[1]);
        mma_3xtf32(tile[n], pb, ps, bb, bs);
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += tile[n][e];
    }
  }
}

// Write a warp's 16 x 64 accumulator chunk (times mul) to rows row0, row0 + 8
// (when below n_rows) and columns c0 + ... (when below D) of a [n_rows, D]
// matrix of T, element by element (D may be odd).
template <typename T>
__device__ __forceinline__ void store_chunk(T* out, const float (&acc)[8][4], float mul, int row0, int n_rows, int D,
                                            int c0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n_rows) continue;
    T* o = out + (size_t)row * D;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = c0 + n * 8 + 2 * t + i;
        if (col < D) o[col] = lfany::from_f<T>(acc[n][2 * r + i] * mul);
      }
    }
  }
}

// Check that rows are whole 16-byte copies and opt in to the shared memory,
// then launch.
template <typename T, typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int smem, int D, void* stream, Args... args) {
  if (D <= 0 || (D * (int)sizeof(T)) % 16) return (int)cudaErrorInvalidValue;
  if (grid.x == 0 || grid.y == 0 || grid.z == 0) return 0;  // nothing to write
  return legacy::launch(kernel, grid, smem, stream, args...);
}

}  // namespace lfbwd
