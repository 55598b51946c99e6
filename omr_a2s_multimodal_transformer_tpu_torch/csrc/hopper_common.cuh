// Hopper building blocks of the redesigned flash kernels (flash_fwd.cu K1,
// flash_bwd.cu K2, flash_dq.cu K3a, flash_dkv.cu K3b): TMA tensor maps
// (host) and loads / reduce-adds (device), the mbarrier ring, wgmma
// descriptors and instructions, fences and register reallocation.
// Everything here is sm_90a PTX.
//
// Shared-memory tiles are 64 rows x 128 bytes (64 bf16 or 32 f32), written
// by TMA with the 128-byte swizzle: the 16-byte chunk c of row r lands at
// chunk c ^ (r % 8). A tile base is 1024-byte aligned, so the swizzle is a
// function of the address bits and wgmma reads the same layout through a
// descriptor of layout type SW128.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes from the runtime, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found through the runtime.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 3-D map over a row-major [B, L, W] tensor (W % 8 == 0, 16-byte aligned
// base): a box is `rows` rows x (128 bytes of columns) of one batch row, with
// the 128-byte swizzle; rows at or past L read as zero and are never
// written. Returns 0 or a cudaError_t.
inline int make_map(CUtensorMap* map, const void* base, CUtensorMapDataType type, int elem_bytes, int B, int L,
                    int W, int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)W * elem_bytes, (cuuint64_t)L * W * elem_bytes};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / elem_bytes), (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, type, 3, const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

inline int make_map_bf16(CUtensorMap* map, const void* base, int B, int L, int W, int rows) {
  return make_map(map, base, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, B, L, W, rows);
}

inline int make_map_f32(CUtensorMap* map, const void* base, int B, int L, int W, int rows) {
  return make_map(map, base, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, B, L, W, rows);
}

// The maps of a flash kernel's q and do ([B, Lq, W] bf16) and k and v
// ([B, Lk, W] bf16), 64-row boxes.
inline int make_qkv_maps(CUtensorMap* tq, CUtensorMap* tdo, CUtensorMap* tk, CUtensorMap* tv, const void* q,
                         const void* dout, const void* k, const void* v, int B, int Lq, int Lk, int W) {
  int err = make_map_bf16(tq, q, B, Lq, W, 64);
  if (!err) err = make_map_bf16(tdo, dout, B, Lq, W, 64);
  if (!err) err = make_map_bf16(tk, k, B, Lk, W, 64);
  if (!err) err = make_map_bf16(tv, v, B, Lk, W, 64);
  return err;
}

// ---------------------------------------------------------------- device

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarriers: `full` completes when its arrivals and the TMA bytes it
// expects are in; `empty` when every consumer thread has released a stage.
// A wait on parity P returns once the phase of parity P has completed.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// TMA: one box of a 3-D map at (column, row, batch) into shared memory,
// completing `bar`'s expected bytes.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// Add a shared-memory box into a 3-D f32 map at (column, row, batch) in one
// bulk reduction (rows at or past L are dropped); bulk_commit closes the group.
__device__ __forceinline__ void tma_reduce_add_3d(const CUtensorMap* map, const void* src, int c0, int c1, int c2) {
  asm volatile("cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.tile.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// Wait until every committed bulk group has read its shared-memory source.
__device__ __forceinline__ void bulk_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }

// Wait until every committed bulk group has completed.
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// Generic-proxy writes to shared memory made visible to wgmma and TMA.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// Named barrier over `threads` threads (ids 1.. ; 0 is __syncthreads).
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// wgmma descriptor of a 128-byte-swizzled tile at `p` (1024-byte aligned
// atoms of 8 rows x 128 bytes). K-major operands advance 32 bytes (+2) per
// 16-element k step inside the row; MN-major ones 2048 bytes (+128) per 16
// rows. Both byte offsets are 1024, the stride of 8-row groups: the K-major
// form ignores the leading one, and for an MN-major 64-wide operand (one
// atom across) only the stride between 8-row groups is read.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = (smem_u32(p) & 0x3FFFFu) >> 4;
  return addr | (uint64_t)(1024 >> 4) << 16 | (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of an accumulator across the
// asynchronous product's issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Whether x holds for any of the `threads` threads that meet at named barrier id.
__device__ __forceinline__ bool named_any(int id, int threads, bool x) {
  uint32_t r;
  asm volatile(
      "{\n .reg .pred p, q;\n setp.ne.u32 p, %1, 0;\n bar.red.or.pred q, %2, %3, p;\n selp.u32 %0, 1, 0, q;\n}\n"
      : "=r"(r)
      : "r"((uint32_t)x), "r"(id), "r"(threads)
      : "memory");
  return r != 0;
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], bf16 in, f32 accumulate; A and B
// from shared memory (TA / TB: 0 K-major, 1 MN-major). Accumulator layout:
// warp w of the warpgroup holds rows 16w + g and 16w + g + 8 (g = lane / 4);
// d[4j + e] is row 16w + g + 8 (e / 2), column 8j + 2 (lane % 4) + e % 2.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),
        "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// The same with A from registers in the mma.sync m16n8k16 A-fragment layout
// (per warp: a[0] row g, columns 2t, 2t+1; a[1] row g + 8; a[2], a[3] the
// same rows at columns + 8), which is the accumulator layout of a 64 x 16
// column block packed to bf16 pairs.
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),
        "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
}

// bf16 A fragments of a 64 x 64 accumulator for a product over its columns:
// a[4 kc .. 4 kc + 3] is the 16-column block kc.
__device__ __forceinline__ void pack_a(uint32_t (&a)[16], const float (&d)[32]) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // i = 0: block 2kc, row g; 1: block 2kc, row g+8; 2, 3: block 2kc+1
      const int j = 2 * kc + (i >> 1), e = (i & 1) * 2;
      __nv_bfloat162 v = __floats2bfloat162_rn(d[4 * j + e], d[4 * j + e + 1]);
      a[4 * kc + i] = *reinterpret_cast<uint32_t*>(&v);
    }
  }
}

}  // namespace hopper
