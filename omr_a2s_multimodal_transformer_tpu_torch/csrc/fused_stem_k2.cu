// K5b: pass B of the fused stem block.
//
// Replaces omr_a2s_multimodal_transformer_tpu/ops/fused_stem.py _k2_kernel
// (:412) and _k2_compute (:462), pallas_call :581. For one ConvBlock, with
// mean and inv from K5a's statistics:
//
//   xh  = round_T(where(in image, (y2 - mean[c]) * inv[c], 0))   (float32)
//   out = round_T(relu(conv3(xh, stride (sh, sw)) + b3) * site-3 factor)
//
// over the unpacked NHWC image: the normalize comes before conv3's zero
// padding (0 outside the image, not -mean * inv); round_T rounds to the
// element type T (float32 or bf16). Site 3 reads the corner
// bits[:, :H3, :Wp, :f_out * co] of the packed draw: unpacked output column
// ox takes the bit of input column (ox / f_out) * f_in + ox % f_out.
//
// bfloat16, fused_stem_k2_tma: a persistent walk like K5a's. A consumer
// warpgroup owns a strip of 64 output columns (one wgmma M) and walks a
// segment of output rows top to bottom in steps of tho rows (the wrapper's
// tile): a step is one stage of the y2 ring, sh x tho y2 rows in and tho
// out rows out (2 stages). It makes them a row at a time; its producer warp
// keeps TMA loads of the y2 rows they read and,
// when the draw makes site 3 elementwise, of the bits rows in flight (the
// corner is a box of a 5-D map over [B, H, Wp, f_in, co] taking f_out of
// the f_in slots). The consumer normalizes each y2 row once into a ring of
// 3 channel-planar rows, so the row a stride-2 window shares with the next
// row is carried; at sw 2 the even and odd columns go to planes of their
// own, so every tap's window is a plane at a 16-byte shift. conv3 is a
// wgmma implicit GEMM (M 64, N co, K 9 x co) with B resident; the epilogue
// of out row oy - 1 runs from a register copy of its accumulator while
// conv3 of row oy is in flight. Out rows leave through a swizzled staging
// row and a TMA store.
//
// float32, fused_stem_k2_kernel: a tho x two tile a block on the CUDA cores
// (conv3x3), a reference of the same function at full precision.
//
// What bounds it on the H100: the bytes of y2, the bits and out (0.15-0.30
// ms per stem block at b8 and 3.35 TB/s); 59 GFLOP of products per block.
#include <string.h>

#include "fused_stem_common.cuh"

using namespace stem;

constexpr int K2_THREADS = 128;

template <bool DROP>
__global__ void __launch_bounds__(K2_THREADS)
fused_stem_k2_kernel(const float* __restrict__ y2, const float* __restrict__ mi, const uint8_t* __restrict__ bits,
                     const float* __restrict__ fchan, const int* __restrict__ scal, const float* __restrict__ w3,
                     const float* __restrict__ b3, float* __restrict__ out, int H, int W, int co, int sh, int sw,
                     int f_in, int f_out, int tho, int two, int t_keep, float inv_e) {
  extern __shared__ float smem[];
  const int H3 = cdiv(H, sh), W3 = W / sw;
  const int tiles_w = cdiv(W3, two);
  const int tile = blockIdx.x, b = blockIdx.y;
  const int oy0 = (tile / tiles_w) * tho, ox0 = (tile % tiles_w) * two;
  const int ir = (tho - 1) * sh + 3, ic = (two - 1) * sw + 3, cop = odd_stride(co);
  float* in_s = smem;

  Drop d{nullptr, nullptr, 0, 0, t_keep, inv_e};
  if constexpr (DROP) {
    d.bits = bits + (size_t)b * H * W * co;
    d.fchan = fchan + (size_t)b * co;
    d.pos = scal[0];
    d.use_elem = scal[1];
  }

  // normalized y2 rows [oy0*sh - 1, +ir), columns [ox0*sw - 1, +ic)
  const float* yb = y2 + (size_t)b * H * W * co;
  const float* mean = mi + (size_t)b * 2 * co;
  const float* inv = mean + co;
  const int y0 = oy0 * sh - 1, x0 = ox0 * sw - 1;
  for (int i = threadIdx.x; i < ir * ic * co; i += blockDim.x) {
    const int r = i / (ic * co), rem = i % (ic * co), c = rem / co, ch = rem % co;
    const int gy = y0 + r, gx = x0 + c;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = (yb[((size_t)gy * W + gx) * co + ch] - __ldg(mean + ch)) * __ldg(inv + ch);
    in_s[(r * ic + c) * cop + ch] = v;
  }
  __syncthreads();

  float* ob = out + (size_t)b * H3 * W3 * co;
  conv3x3(in_s, ic, cop, co, tho, two, sh, sw, w3, co, [&](int ly, int lx, int oc0, const float(&acc)[OCB]) {
    const int oy = oy0 + ly, ox = ox0 + lx;
    if (oy >= H3 || ox >= W3) return;
    float fac[OCB], v[OCB];
    if constexpr (DROP) {
      const int bx = (ox / f_out) * f_in + ox % f_out;
      site_factors(fac, d, 3, d.bits + ((size_t)oy * W + bx) * co + oc0, d.fchan + oc0);
    }
#pragma unroll
    for (int j = 0; j < OCB; ++j) {
      v[j] = fmaxf(acc[j] + b3[oc0 + j], 0.f);
      if constexpr (DROP) v[j] *= fac[j];
    }
    store16(ob + ((size_t)oy * W3 + ox) * co + oc0, v);
  });
}

static int k2_smem_bytes(int co, int sh, int sw, int tho, int two) {
  return ((tho - 1) * sh + 3) * ((two - 1) * sw + 3) * odd_stride(co) * 4;
}

template <bool DROP>
static int launch(const void* y2, const void* mi, const void* bits, const void* fchan, const void* scal,
                  const void* w3, const void* b3, void* out, int B, int H, int W, int co, int sh, int sw, int f_in,
                  int f_out, int tho, int two, int t_keep, float inv_e, cudaStream_t stream) {
  const int smem = k2_smem_bytes(co, sh, sw, tho, two);
  auto kern = fused_stem_k2_kernel<DROP>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = cdiv(cdiv(H, sh), tho) * cdiv(W / sw, two);
  kern<<<dim3(n_tiles, B), K2_THREADS, smem, stream>>>(
      (const float*)y2, (const float*)mi, (const uint8_t*)bits, (const float*)fchan, (const int*)scal, (const float*)w3,
      (const float*)b3, (float*)out, H, W, co, sh, sw, f_in, f_out, tho, two, t_keep, inv_e);
  return (int)cudaGetLastError();
}

// ---- bfloat16: the persistent strip walk

// k5b:: (the strip, the rings and the shared-memory layout) is in fused_stem_layout.h.

template <int CO, int SW>
__global__ void __launch_bounds__(CONS_THREADS + PROD_THREADS, min_blocks(CO))
fused_stem_k2_tma(const __grid_constant__ CUtensorMap ty2, const __grid_constant__ CUtensorMap tbits,
                  const __grid_constant__ CUtensorMap tout, const bf16* __restrict__ w3op,
                  const bf16* __restrict__ b3, const float* __restrict__ mi, const float* __restrict__ fchan,
                  const int* __restrict__ scal, int B, int H, int W, int sh, int R, int f_out, int n_strips,
                  int n_seg, int seg_len, int has_drop, int t_keep, float inv_e) {
  using namespace hopper;
  using namespace k5b;
  constexpr int NJ = CO / 8, NA = CO / 2, NG = CO / 8, IN_COLS = 63 * SW + 3;
  constexpr int CHUNKS = IN_COLS * NG, PER = (CHUNKS + CONS_THREADS - 1) / CONS_THREADS;  // 16-byte chunks a row
  // the 1024-byte aligned base, as an offset into the shared array: a pointer rebuilt from an integer would
  // lose its state space and turn every access of the tiles into a generic one
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024u - (hopper::smem_u32(smem_raw) & 1023u)) & 1023u);
  const Layout L = layout(CO, SW, R, has_drop);
  const SiteDrop d{has_drop ? scal[0] : 0, has_drop ? scal[1] : 0, t_keep, inv_e};
  const bool bits_on = d.use_elem && d.pos == 3;
  const int H3 = cdiv(H, sh);

  copy_to_smem(sm, w3op, weight_bytes(CO, CO));
  unsigned char* reg = sm + L.wbytes;  // the consumer's region
  uint64_t* rfull = reinterpret_cast<uint64_t*>(reg + L.bar);
  uint64_t* rempty = rfull + NST;
  uint64_t* bfull = rfull + 2 * NST;
  uint64_t* bempty = bfull + NBS;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(&rfull[s], 1);   // the producer's arrival and the TMA bytes
      mbar_init(&rempty[s], 1);  // the consumer's thread 0, after the barrier that ends its reads
    }
    for (int s = 0; s < NBS; ++s) {
      mbar_init(&bfull[s], 1);
      mbar_init(&bempty[s], CONS_THREADS);
    }
    fence_barrier_init();
  }
  fence_proxy_async();
  __syncthreads();

  const int n_units = B * n_seg * n_strips;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == 4) {
    if (lane != 0) return;
    const uint32_t raw_bytes = R * IN_COLS * CO * 2;
    int rs = 0, bs = 0;
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const Unit t = unit_of(u, n_strips, n_seg, seg_len, H3);
      const int ox0 = t.strip * STRIP, ya = sh * t.r0 - 1, ns = cdiv(sh * (t.r1 - 1 - t.r0) + 3, R);
      int issued = 0;
      for (int oy = t.r0; oy < t.r1; ++oy) {
        const int need = min(ns, (sh * oy + 1 - ya) / R + 1);  // the stages through y2 row sh * oy + 1
        for (; issued < need; ++issued, ++rs) {
          const int s = rs % NST;
          mbar_wait(&rempty[s], ((rs / NST) & 1) ^ 1);
          mbar_arrive_expect_tx(&rfull[s], raw_bytes);
          tma_load_4d(reg + L.raw + s * L.raw_stage, &ty2, &rfull[s], 0, SW * ox0 - 1, ya + issued * R, t.b);
        }
        if (bits_on) {
          const int s = bs % NBS;
          mbar_wait(&bempty[s], ((bs / NBS) & 1) ^ 1);
          mbar_arrive_expect_tx(&bfull[s], 64 * CO);
          tma_load_5d(reg + L.bits + s * 64 * CO, &tbits, &bfull[s], 0, 0, ox0 / f_out, oy, t.b);
          ++bs;
        }
      }
    }
    return;
  }

  // ---- consumer
  const int tid = threadIdx.x & 127, w = tid >> 5, g = lane >> 2, tq = lane & 3, m_a = 16 * w + g;
  const int grp = tid % NG;  // the 8 channels this thread normalizes (NG divides 128)
  constexpr int bar_id = 1;
  const uint32_t w3a = smem_u32(sm), rega = smem_u32(reg);
  float bias3[2 * NJ], fch[2 * NJ], mean8[8], inv8[8], acc[NA], accp[NA];
#pragma unroll
  for (int i = 0; i < 2 * NJ; ++i) bias3[i] = __bfloat162float(b3[8 * (i >> 1) + 2 * tq + (i & 1)]);
  int rs_base = 0, bs = 0, stg_n = 0;
  PendingRow pend{0, 0, 0, 0, 0};

  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    const Unit t = unit_of(u, n_strips, n_seg, seg_len, H3);
    const int ox0 = t.strip * STRIP, ya = sh * t.r0 - 1, n_in = sh * (t.r1 - 1 - t.r0) + 3, ns = cdiv(n_in, R);
    int waited = 0, released = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      mean8[i] = __ldg(mi + (size_t)t.b * 2 * CO + grp * 8 + i);
      inv8[i] = __ldg(mi + (size_t)t.b * 2 * CO + CO + grp * 8 + i);
    }
#pragma unroll
    for (int i = 0; i < 2 * NJ; ++i)
      fch[i] = d.pos == 3 && !d.use_elem ? __ldg(fchan + t.b * CO + 8 * (i >> 1) + 2 * tq + (i & 1)) : 1.f;

    // out rows from accp: relu(conv3 + b3) * site-3 factor (bits in bprev), rounded and staged for the store
    const uint8_t* bprev = nullptr;
    int bslot_prev = 0;
    auto out_pair = [&](int p) {  // pair p: row half p / NJ, columns 8 (p % NJ) + 2tq
      const int hf = p / NJ, j = p % NJ, m = m_a + 8 * hf;
      unsigned char* st = reg + (stg_n & 1) * L.stg_row;
      const float2 f = pair_factor(d, 3, bprev + m * CO + 8 * j + 2 * tq, make_float2(fch[2 * j], fch[2 * j + 1]));
      *reinterpret_cast<uint32_t*>(st + stg_swizzle<CO>(m * CO * 2 + (8 * j + 2 * tq) * 2)) =
          pack_bf2(fmaxf(accp[4 * j + 2 * hf] + bias3[2 * j], 0.f) * f.x,
                   fmaxf(accp[4 * j + 2 * hf + 1] + bias3[2 * j + 1], 0.f) * f.y);
    };
    auto out_done = [&](int oy) {  // the row is staged: release its bits, queue its store
      if (bits_on) mbar_arrive(&bempty[bslot_prev]);
      pend = PendingRow{1, stg_n & 1, ox0, oy, t.b};
      ++stg_n;
    };

    // ring slots of normalized rows, (row - ya) % 3: xn of the next row to normalize, xc of row sh oy - 1
    auto slot3 = [](int s) { return s >= 3 ? s - 3 : s; };
    int xn = 0, xc = 0;
    for (int oy = t.r0; oy < t.r1; ++oy) {
      // normalize the y2 rows conv3 of row oy reads that are not in the ring yet; a thread's chunks are
      // loaded all at once, then normalized
      for (int iy = oy == t.r0 ? ya : sh * oy + 2 - sh; iy <= sh * oy + 1; ++iy) {
        const int k = (iy - ya) / R, st = (rs_base + k) % NST;
        for (; waited <= k; ++waited) mbar_wait(&rfull[(rs_base + waited) % NST], ((rs_base + waited) / NST) & 1);
        const unsigned char* raw = reg + L.raw + st * L.raw_stage + ((iy - ya) % R) * IN_COLS * CO * 2;
        unsigned char* xs = reg + L.xh + xn * L.xh_slot;
        const bool rowin = iy >= 0 && iy < H;
        uint4 q[PER];
        uint32_t in_img = 0u;
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          const int lc = (tid + i * CONS_THREADS) / NG, col = SW * ox0 - 1 + lc;
          const bool in = tid + i * CONS_THREADS < CHUNKS && rowin && col >= 0 && col < W;
          q[i] = in ? *reinterpret_cast<const uint4*>(raw + (lc * CO + grp * 8) * 2) : make_uint4(0u, 0u, 0u, 0u);
          in_img |= (uint32_t)in << i;
        }
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          if (tid + i * CONS_THREADS >= CHUNKS) continue;
          const int lc = (tid + i * CONS_THREADS) / NG;
          if (in_img >> i & 1u) {
            const uint32_t in[4] = {q[i].x, q[i].y, q[i].z, q[i].w};
            uint32_t o[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&in[e]));
              o[e] = pack_bf2((f.x - mean8[2 * e]) * inv8[2 * e], (f.y - mean8[2 * e + 1]) * inv8[2 * e + 1]);
            }
            q[i] = make_uint4(o[0], o[1], o[2], o[3]);
          }
          const int par = SW == 2 ? (lc & 1) : 0, px = SW == 2 ? (lc >> 1) : lc;
          *reinterpret_cast<uint4*>(xs + par * L.xh_q + grp * L.xh_plane + px * 16) = q[i];
        }
        xn = slot3(xn + 1);
      }
      fence_proxy_async();
      if (tid == 0) bulk_wait_read();
      named_sync(bar_id, CONS_THREADS);
      // y2 stages whose rows are all normalized (rows ya .. sh oy + 1 of the unit) are free
      for (const int full = oy + 1 == t.r1 ? ns : (sh * oy + 2 - ya) / R; released < full; ++released)
        if (tid == 0) mbar_arrive(&rempty[(rs_base + released) % NST]);
      if (tid == 0 && pend.on) {
        tma_store_4d(&tout, reg + pend.buf * L.stg_row, 0, pend.col, pend.row, pend.b);
        bulk_commit();
      }
      pend.on = 0;
      // conv3 of row oy: tap (dy, dx) reads normalized row sh * oy - 1 + dy at columns sw * (ox0 + m) - 1 + dx
      wgmma_fence();
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const uint32_t base = rega + L.xh + slot3(xc + dy) * L.xh_slot;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const uint32_t a0 = base + (SW == 2 ? (dx & 1) * L.xh_q + (dx >> 1) * 16 : dx * 16);
#pragma unroll
          for (int kc = 0; kc < CO / 16; ++kc)
            Wgmma<CO>::ss(acc, plain_desc(a0 + 2 * kc * L.xh_plane, L.xh_plane, 128),
                          plain_desc(w3a + ((dy * 3 + dx) * (CO / 16) + kc) * 32 * CO, 16 * CO, 128),
                          (dy | dx | kc) != 0);
        }
      }
      wgmma_commit();
      // out row oy - 1 from the copy of its accumulator while conv3 of row oy runs: after its issue
      // (pairs interleaved between the taps' products ran 10% slower)
      if (oy > t.r0) {
#pragma unroll
        for (int p = 0; p < 2 * NJ; ++p) out_pair(p);
        out_done(oy - 1);
      }
      xc = slot3(xc + sh);
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int i = 0; i < NA; ++i) accp[i] = acc[i];
      if (bits_on) {  // site 3's bits of row oy, for its epilogue at the next row
        bslot_prev = bs % NBS;
        mbar_wait(&bfull[bslot_prev], (bs / NBS) & 1);
        bprev = reg + L.bits + bslot_prev * 64 * CO;
        ++bs;
      }
    }
    // the unit's last out row, after a barrier that lets its staging row be rewritten
    fence_proxy_async();
    if (tid == 0) bulk_wait_read();
    named_sync(bar_id, CONS_THREADS);
    if (tid == 0 && pend.on) {
      tma_store_4d(&tout, reg + pend.buf * L.stg_row, 0, pend.col, pend.row, pend.b);
      bulk_commit();
    }
    pend.on = 0;
#pragma unroll
    for (int p = 0; p < 2 * NJ; ++p) out_pair(p);
    out_done(t.r1 - 1);
    rs_base += ns;
  }
  fence_proxy_async();
  if (tid == 0) bulk_wait_read();
  named_sync(bar_id, CONS_THREADS);
  if (tid == 0) {
    if (pend.on) {
      tma_store_4d(&tout, reg + pend.buf * L.stg_row, 0, pend.col, pend.row, pend.b);
      bulk_commit();
    }
    bulk_wait();
  }
}

template <int CO, int SW>
static int launch_tma(const void* y2, const void* mi, const void* bits, const void* fchan, const void* scal,
                      const void* w3op, const void* b3, void* out, int B, int H, int W, int sh, int f_in, int f_out,
                      int R, int grid, int seg_len, int has_drop, int t_keep, float inv_e, cudaStream_t stream) {
  using namespace k5b;
  const int H3 = cdiv(H, sh), W3 = W / SW, Wp = W / f_in;
  CUtensorMap ty, tb, to;
  memset(&tb, 0, sizeof(tb));
  int err = make_nhwc_map(&ty, y2, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, B, H, W, CO, CO, in_cols(SW), R,
                          CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!err && has_drop) {  // the packed draw as (co, f_in, Wp, H, B): a box takes the f_out slots of site 3
    uint64_t dims[5], strides[4];
    uint32_t box[5];
    fused_stem_site3_map(B, H, Wp, f_in, f_out, CO, dims, strides, box);
    err = hopper::make_map_nd(&tb, bits, CU_TENSOR_MAP_DATA_TYPE_UINT8, 5, dims, strides, box,
                              CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (!err)
    err = make_nhwc_map(&to, out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, B, H3, W3, CO, CO, STRIP, 1,
                        stg_swizzle_mode(CO));
  if (err) return err;
  const int smem = layout(CO, SW, R, has_drop).total;
  auto kern = fused_stem_k2_tma<CO, SW>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int n_strips = cdiv(W3, STRIP), n_seg = cdiv(H3, seg_len);
  kern<<<grid, CONS_THREADS + PROD_THREADS, smem, stream>>>(
      ty, tb, to, (const bf16*)w3op, (const bf16*)b3, (const float*)mi, (const float*)fchan, (const int*)scal, B, H, W,
      sh, R, f_out, n_strips, n_seg, seg_len, has_drop, t_keep, inv_e);
  return (int)cudaGetLastError();
}

template <int CO>
static int launch_bf16(int sw, const void* y2, const void* mi, const void* bits, const void* fchan,
                       const void* scal, const void* w3op, const void* b3, void* out, int B, int H, int W, int sh,
                       int f_in, int f_out, int R, int grid, int seg_len, int has_drop, int t_keep, float inv_e,
                       cudaStream_t stream) {
#define K2_TMA_ARGS \
  y2, mi, bits, fchan, scal, w3op, b3, out, B, H, W, sh, f_in, f_out, R, grid, seg_len, has_drop, t_keep, inv_e, stream
  return sw == 2 ? launch_tma<CO, 2>(K2_TMA_ARGS) : launch_tma<CO, 1>(K2_TMA_ARGS);
#undef K2_TMA_ARGS
}

// dtype 0 float32 (CUDA cores: tiles of rows x two output pixels); 1
// bfloat16 (the strip walk: w3op the weights' wgmma operand, `rows` y2
// rows a stage, what fused_stem_k2_fit takes; `grid` blocks, segments of
// seg_len output rows).
// y2 [B, H, W, co], mi float32 [B, 2, co] (mean, inv), bits [B, H, W, co]
// (null without dropout), fchan [B, co], scal int32 {pos, use_elem} on the
// device, out [B, ceil(H/sh), W/sw, co]; f_out * sw == f_in.
extern "C" int fused_stem_k2_launch(const void* y2, const void* mi, const void* bits, const void* fchan,
                                    const void* scal, const void* w3, const void* w3op, const void* b3, void* out,
                                    int dtype, int has_drop, int B, int H, int W, int co, int sh, int sw, int f_in,
                                    int f_out, int rows, int two, int grid, int seg_len, int t_keep,
                                    float inv_e, void* stream) {
  if (co % OCB || W % sw || f_out * sw != f_in || rows < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    if (k2_smem_bytes(co, sh, sw, rows, two) > SMEM_MAX) return (int)cudaErrorInvalidValue;
    return has_drop ? launch<true>(y2, mi, bits, fchan, scal, w3, b3, out, B, H, W, co, sh, sw, f_in, f_out, rows, two,
                                   t_keep, inv_e, s)
                    : launch<false>(y2, mi, bits, fchan, scal, w3, b3, out, B, H, W, co, sh, sw, f_in, f_out, rows,
                                    two, t_keep, inv_e, s);
  }
  int fit[5];
  if (dtype != 1 || fused_stem_k2_fit(co, sh, sw, f_out, rows, has_drop, fit) != STEM_FIT_OK || grid < 1 ||
      seg_len < 1)
    return (int)cudaErrorInvalidValue;
#define K2_BF16_ARGS \
  sw, y2, mi, bits, fchan, scal, w3op, b3, out, B, H, W, sh, f_in, f_out, rows, grid, seg_len, has_drop, \
      t_keep, inv_e, s
  return co == 16 ? launch_bf16<16>(K2_BF16_ARGS) : co == 32 ? launch_bf16<32>(K2_BF16_ARGS) : launch_bf16<64>(K2_BF16_ARGS);
#undef K2_BF16_ARGS
}
