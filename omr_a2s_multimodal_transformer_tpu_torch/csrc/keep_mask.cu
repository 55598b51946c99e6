// K4: the dropout keep-mask probe.
//
// Replaces omr_a2s_multimodal_transformer_tpu/ops/flash_packed.py
// export_keep_masks.kern (:747, pallas_call :752): it writes the keep bits
// that the flash kernels (K1, K1c, K2, K3a, K3b) regenerate, as a dense
// out[b, h, q, k] of bytes (1 = keep) over the padded [B, H, Lq_p, Lk_p],
// with the hash of flash_common.cuh at the caller's mask geometry (mbq,
// mbk): bit for bit the mask each kernel applies.
//
// What bounds it on the H100: it reads nothing and writes B*H*Lq_p*Lk_p
// bytes (587 MB at the cross shape with 128/2048 blocks: 0.175 ms at
// 3.35 TB/s; filling the same tensor takes 0.18 ms), and each byte is a
// hash. Hashed as written (x = mix ^ row ^ col, then the murmur3
// finalizer) a byte cost the first design 19 integer instructions, 13 of
// them on the INT32 / logic pipe (64 lanes an SM): that, not the bytes,
// set its time (0.50 ms). This design takes a byte in about 8.7
// instructions, 5.5 on the logic pipe and 3.2 on the multiply (FMA) pipe
// (88 logic and 51 multiply instructions a 16-byte store in the loop's
// SASS, a row's share of the walk included):
// - the terms that do not depend on the byte are hoisted: x ^ (x >> 16)
//   distributes over xor, so a lane keeps fold16(col * COL_MUL) of its 16
//   keys in registers for the rows it walks and folds the row term
//   fold16(mix ^ row * ROW_MUL) once a row; a byte starts from one xor;
// - the finalizer's last step y ^= y >> 16 is folded into the compare:
//   y ^ (y >> 16) has y's high half and (low ^ high) as its low half, so
//   it is >= thresh exactly when y ^ (thresh >> 16) is (equal high halves
//   make the low halves the same): one xor instead of a shift and an xor;
// - the compare and the byte pack are one carry chain: y + (2^32 - thresh)
//   carries exactly when y >= thresh, and a multiply-add with carry-in
//   shifts the carry into the word: w = w * 256 + carry. The 256 comes in
//   as a kernel argument: as a literal, with the same instruction count,
//   K4 ran 2.2% slower at the cross shape on the H100, in each of 10
//   alternating pairs.
// The logic pipe then sets a floor of 0.193 ms at the cross shape at the
// card's top clock (1980 MHz), above the memory's; K4 runs 0.21. y ^= y >>
// 13 stays a shift: as a multiply-high (__umulhi by 2^19) on the multiply
// pipe it ran 8% slower. The walk is persistent (keep_mask_plan.h): a grid
// of 4 blocks an SM whose warps each write equal runs of 512-key row
// strips with coalesced 16-byte stores.
#include "flash_common.cuh"
#include "keep_mask_plan.h"

using namespace flash;

// w * byte_mul + (z >= thresh), as (z + neg_thresh) carries exactly when
// z >= thresh (neg_thresh = 2^32 - thresh, thresh > 0; byte_mul 256).
__device__ __forceinline__ uint32_t push_keep(uint32_t w, uint32_t z, uint32_t neg_thresh, uint32_t byte_mul) {
  asm("{\n\t.reg .u32 t;\n\tadd.cc.u32 t, %1, %2;\n\tmadc.lo.u32 %0, %0, %3, 0;\n\t}"
      : "+r"(w)
      : "r"(z), "r"(neg_thresh), "r"(byte_mul));
  return w;
}

// The rows a lane writes (km::walk's visitor): ALL for rate 0 (thresh 0:
// every byte keeps).
template <bool ALL>
struct KeepRows {
  uint8_t* out;
  int Lk, seed, mbq, mbk;
  uint32_t t_hi, neg_thresh, byte_mul;  // thresh >> 16, 2^32 - thresh, 256
  uint8_t* col;
  int kb;
  uint32_t c[km::KEYS];  // fold16 of the lane's column terms
  uint32_t mix, row_term;

  __device__ __forceinline__ void strip(int k0) {
    col = out + k0;
    kb = k0 / mbk;
    const uint32_t c0 = (uint32_t)(k0 % mbk);  // 16 keys lie inside one mask k-block (mbk % 16 == 0)
#pragma unroll
    for (int i = 0; i < km::KEYS; ++i) c[i] = fold16((c0 + i) * COL_MUL);
  }

  __device__ __forceinline__ void block(int b, int h, int qi, int qm) {
    mix = block_mix(seed, b, qi, kb);
    row_term = (uint32_t)(h * mbq + qm) * ROW_MUL;
  }

  // bytes 4j..4j+3 of the row with folded row term a
  __device__ __forceinline__ uint32_t word(uint32_t a, int j) const {
    uint32_t w = 0;
#pragma unroll
    for (int i = 3; i >= 0; --i) {  // the highest byte first: it ends in the top of w
      uint32_t y = (a ^ c[4 * j + i]) * FMIX_MUL1;
      y ^= y >> 13;
      w = push_keep(w, (y * FMIX_MUL2) ^ t_hi, neg_thresh, byte_mul);  // (y ^ (y >> 16)) >= thresh
    }
    return w;
  }

  __device__ __forceinline__ void row(int64_t r) {
    uint4 v = make_uint4(0x01010101u, 0x01010101u, 0x01010101u, 0x01010101u);
    if (!ALL) {
      const uint32_t a = fold16(mix ^ row_term);
      v = make_uint4(word(a, 0), word(a, 1), word(a, 2), word(a, 3));
    }
    row_term += ROW_MUL;
    *reinterpret_cast<uint4*>(col + r * Lk) = v;
  }
};

__global__ void __launch_bounds__(km::THREADS, km::BLOCKS_PER_SM)
keep_mask_kernel(const int* __restrict__ seed_p, uint8_t* __restrict__ out, int B, int H, int Lq, int Lk, int mbq,
                 int mbk, uint32_t thresh, uint32_t byte_mul) {
  const km::Geometry g{B, H, Lq, Lk, mbq, (int64_t)gridDim.x * (km::THREADS / 32)};
  const int64_t w = ((int64_t)blockIdx.x * km::THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  const int seed = *seed_p;
  if (thresh == 0) {
    KeepRows<true> v{out, Lk, seed, mbq, mbk};
    km::walk(g, w, lane, v);
  } else {
    KeepRows<false> v{out, Lk, seed, mbq, mbk, thresh >> 16, 0u - thresh, byte_mul};
    km::walk(g, w, lane, v);
  }
}

// km::BLOCKS_PER_SM blocks an SM of the current device. The wrapper
// (ops/flash_packed.py keep_mask_cuda) checks the geometry: mbk and Lk
// multiples of km::KEYS, Lq a multiple of mbq.
extern "C" int keep_mask_launch(const void* seed, void* out, int B, int H, int Lq, int Lk, int mbq, int mbk,
                                unsigned int thresh, void* stream) {
  int dev = 0, n_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  keep_mask_kernel<<<n_sm * km::BLOCKS_PER_SM, km::THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)seed, (uint8_t*)out, B, H, Lq, Lk, mbq, mbk, thresh, 256u);
  return (int)cudaGetLastError();
}
