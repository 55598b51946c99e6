// K4: the dropout keep-mask probe.
//
// Replaces omr_a2s_multimodal_transformer_tpu/ops/flash_packed.py
// export_keep_masks.kern (:747, pallas_call :752): it writes the keep bits
// that the flash kernels (K1, K1c, K2, K3a, K3b) regenerate, as a dense
// out[b, h, q, k] of bytes (1 = keep) over the padded [B, H, Lq_p, Lk_p],
// with the hash of flash_common.cuh (block_mix, keep_bit) at the caller's
// mask geometry (mbq, mbk): bit for bit the mask each kernel applies.
//
// One thread writes 16 consecutive keys of one (b, h, q) row as one 16-byte
// store; the 16 keys lie in one mask k-block (mbk % 16 == 0), so the block
// term is hashed once and the column term is advanced by a constant. A block
// of 256 threads covers 4096 keys of a row.
//
// What bounds it on the H100: it reads nothing and writes B*H*Lq_p*Lk_p
// bytes (587 MB at the cross shape with 128/2048 blocks, 0.18 ms at
// 3.35 TB/s), with ~12 integer operations per byte of hash; bytes bound it
// if the integer pipes keep up, which the 16 hashes per store leave to
// measurement.
#include "flash_common.cuh"

using namespace flash;

constexpr int KM_THREADS = 256;
constexpr int KM_KEYS = 16;  // keys per thread: one 16-byte store

__global__ void __launch_bounds__(KM_THREADS)
keep_mask_kernel(const int* __restrict__ seed_p, uint8_t* __restrict__ out, int H, int Lq, int Lk,
                 int mbq, int mbk, uint32_t thresh) {
  const int q = blockIdx.y, bh = blockIdx.z;
  const int b = bh / H, h = bh % H;
  const int k0 = (blockIdx.x * KM_THREADS + threadIdx.x) * KM_KEYS;
  if (k0 >= Lk) return;
  const uint32_t mixmul = block_mix(*seed_p, b, q / mbq, k0 / mbk);
  const uint32_t row_term = (uint32_t)(h * mbq + q % mbq) * ROW_MUL;
  const uint32_t col_term = (uint32_t)(k0 % mbk) * COL_MUL;
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < KM_KEYS; ++i) {
    const uint32_t x = mixmul ^ row_term ^ (col_term + (uint32_t)i * COL_MUL);
    w[i >> 2] |= (keep_bit(x, thresh) ? 1u : 0u) << (8 * (i & 3));
  }
  *reinterpret_cast<uint4*>(out + ((size_t)bh * Lq + q) * Lk + k0) = make_uint4(w[0], w[1], w[2], w[3]);
}

extern "C" int keep_mask_launch(const void* seed, void* out, int B, int H, int Lq, int Lk, int mbq,
                                int mbk, unsigned int thresh, void* stream) {
  dim3 grid((Lk / KM_KEYS + KM_THREADS - 1) / KM_THREADS, Lq, B * H);
  keep_mask_kernel<<<grid, KM_THREADS, 0, (cudaStream_t)stream>>>((const int*)seed, (uint8_t*)out, H, Lq, Lk,
                                                                  mbq, mbk, thresh);
  return (int)cudaGetLastError();
}
