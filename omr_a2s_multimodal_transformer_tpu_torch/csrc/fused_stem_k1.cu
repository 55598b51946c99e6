// K5a: pass A of the fused stem block.
//
// Replaces omr_a2s_multimodal_transformer_tpu/ops/fused_stem.py _k1_kernel
// (:288) and _k1_compute (:340), pallas_call :521. For one ConvBlock:
//
//   h1 = round_T(where(in image, relu(conv1(x) + b1) * site-1 factor, 0))
//   y2 = round_T(relu(conv2(h1) + b2) * site-2 factor)
//   stats[b, 0, c] = sum of y2[b, ..., c], stats[b, 1, c] = sum of y2^2
//
// over the unpacked NHWC image (module note in fused_stem_common.cuh), with
// zero padding of x before conv1 and of h1 before conv2, and statistics of
// the stored (rounded) y2; round_T rounds to the element type T (float32
// or bf16), and sums are float32. The statistics are sums of per-block (or
// per-unit) partials added by a second kernel in a fixed order, so they are
// the same bits on every run (no float atomics).
//
// bfloat16 (the train step's type), fused_stem_k1_tma: the TPU kernel's
// sequential walk down the image, made a loop inside a persistent block.
// A consumer warpgroup owns a column strip of 62 y2 columns (64 h1 columns:
// one wgmma M) and walks a segment of its rows top to bottom in steps of
// R rows, the TPU kernel's tile height (the wrapper's tile_h): a step is
// one stage of the x ring, R x rows in and R y2 rows out. It makes them a
// row at a time: conv1 makes h1 row y (into a ring of 3 h1 rows in shared memory,
// so conv1's vertical halo is carried, never recomputed; only the 2 h1
// columns the neighbouring strips also make are), conv2 makes y2 row y - 1
// from the 3 h1 rows above and below it. Its producer warp keeps TMA loads
// of x rows (R rows a stage, 4 stages; the maps' zero fill is conv1's
// padding) and, when the draw makes site 1 or 2 elementwise, of the dropout
// bits rows in flight. Both products are wgmma implicit GEMMs (M 64 pixels,
// N co, K 9 taps x channels) with A read from the channel-planar rows and
// B from the weights, resident for the whole walk; conv1 of the first stem
// block (ci 1) is one k16 step over its 9 taps zero-padded to 16, its A
// staged in shared memory from the x rows each row.
// conv2 of row y - 1 and conv1 of row y + 1 are in flight together while
// the epilogue of y2 row y - 2 runs from a register copy of its
// accumulator, and retire before the row ends (a read of an accumulator
// while another product is in flight made ptxas serialize the products).
// y2 rows leave through a swizzled staging row and a TMA store;
// per-thread float32 sums of the stored y2 are reduced once per unit in a
// fixed order into the unit's partial. Units (image, row segment, strip)
// are cut from the SM count by the wrapper (k1_plan).
//
// float32, fused_stem_k1_kernel: a th x tw tile a block on the CUDA cores
// (conv3x3), with the 1-pixel h1 halo recomputed by neighbouring tiles: a
// reference of the same function at full precision.
//
// What bounds it on the H100: 62-354 GFLOP of 3x3 products per stem block
// at b8 (0.19-0.37 ms of bytes at 3.35 TB/s, block2 0.36 ms of bf16 tensor
// operations). The bf16 kernel reads each x row once (plus a 4-column halo
// in 66) and writes y2 once; its products at co 16 and 32 are bound by the
// A operand's shared-memory reads more than by the tensor cores.
#include <string.h>

#include "fused_stem_common.cuh"

using namespace stem;

constexpr int K1_THREADS = 256;
constexpr int STATS_THREADS = 512;

template <bool DROP>
__global__ void __launch_bounds__(K1_THREADS)
fused_stem_k1_kernel(const float* __restrict__ x, const uint8_t* __restrict__ bits, const float* __restrict__ fchan,
                     const int* __restrict__ scal, const float* __restrict__ w1, const float* __restrict__ b1,
                     const float* __restrict__ w2, const float* __restrict__ b2, float* __restrict__ y2,
                     float* __restrict__ partial, int H, int W, int ci, int co, int th, int tw, int t_keep,
                     float inv_e) {
  extern __shared__ float smem[];
  const int tiles_w = cdiv(W, tw), n_tiles = cdiv(H, th) * tiles_w;
  const int tile = blockIdx.x, b = blockIdx.y;
  const int r0 = (tile / tiles_w) * th, c0 = (tile % tiles_w) * tw;
  const int cip = odd_stride(ci), cop = odd_stride(co);
  const int xc = tw + 4, hr = th + 2, hc = tw + 2;
  const int x_floats = (th + 4) * xc * cip;
  float* x_s = smem;  // x tile, later the y2 tile (th * tw * co)
  float* h1_s = smem + max(x_floats, th * tw * co);
  float* red_s = h1_s + hr * hc * cop;

  Drop d{nullptr, nullptr, 0, 0, t_keep, inv_e};
  if constexpr (DROP) {
    d.bits = bits + (size_t)b * H * W * co;
    d.fchan = fchan + (size_t)b * co;
    d.pos = scal[0];
    d.use_elem = scal[1];
  }

  // x rows [r0-2, r0+th+2), columns [c0-2, c0+tw+2), zero outside the image
  const float* xb = x + (size_t)b * H * W * ci;
  for (int i = threadIdx.x; i < (th + 4) * xc * ci; i += blockDim.x) {
    const int r = i / (xc * ci), rem = i % (xc * ci), c = rem / ci, ch = rem % ci;
    const int gy = r0 - 2 + r, gx = c0 - 2 + c;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = xb[((size_t)gy * W + gx) * ci + ch];
    x_s[(r * xc + c) * cip + ch] = v;
  }
  __syncthreads();

  // h1 at rows [r0-1, r0+th+1), columns [c0-1, c0+tw+1); 0 outside the image
  conv3x3(x_s, xc, cip, ci, hr, hc, 1, 1, w1, co, [&](int oy, int ox, int oc0, const float(&acc)[OCB]) {
    const int gy = r0 - 1 + oy, gx = c0 - 1 + ox;
    float* dst = h1_s + (oy * hc + ox) * cop + oc0;
    if (gy < 0 || gy >= H || gx < 0 || gx >= W) {
#pragma unroll
      for (int j = 0; j < OCB; ++j) dst[j] = 0.f;
      return;
    }
    float fac[OCB];
    if constexpr (DROP) site_factors(fac, d, 1, d.bits + ((size_t)gy * W + gx) * co + oc0, d.fchan + oc0);
#pragma unroll
    for (int j = 0; j < OCB; ++j) {
      float v = fmaxf(acc[j] + b1[oc0 + j], 0.f);
      if constexpr (DROP) v *= fac[j];
      dst[j] = v;
    }
  });
  __syncthreads();

  // y2 on the tile: stored to device memory and to the y2 tile
  float* y2_s = x_s;
  float* y2b = y2 + (size_t)b * H * W * co;
  conv3x3(h1_s, hc, cop, co, th, tw, 1, 1, w2, co, [&](int oy, int ox, int oc0, const float(&acc)[OCB]) {
    const int gy = r0 + oy, gx = c0 + ox;
    float* dst = y2_s + (oy * tw + ox) * co + oc0;
    float v[OCB];
    if (gy >= H || gx >= W) {
#pragma unroll
      for (int j = 0; j < OCB; ++j) dst[j] = 0.f;
      return;
    }
    float fac[OCB];
    if constexpr (DROP) site_factors(fac, d, 2, d.bits + ((size_t)gy * W + gx) * co + oc0, d.fchan + oc0);
#pragma unroll
    for (int j = 0; j < OCB; ++j) {
      v[j] = fmaxf(acc[j] + b2[oc0 + j], 0.f);
      if constexpr (DROP) v[j] *= fac[j];
      dst[j] = v[j];
    }
    store16(y2b + ((size_t)gy * W + gx) * co + oc0, v);
  });
  __syncthreads();

  // per-channel sums of the tile, in a fixed order: thread (part, c) adds
  // pixels part, part + nparts, ...; then the parts in order
  const int nparts = blockDim.x / co, c = threadIdx.x % co, part = threadIdx.x / co;
  float s1 = 0.f, s2 = 0.f;
  if (part < nparts) {
    for (int p = part; p < th * tw; p += nparts) {
      const float v = y2_s[p * co + c];
      s1 += v;
      s2 += v * v;
    }
  }
  red_s[threadIdx.x] = s1;
  red_s[blockDim.x + threadIdx.x] = s2;
  __syncthreads();
  if (threadIdx.x < co) {
    float t1 = 0.f, t2 = 0.f;
    for (int q = 0; q < nparts; ++q) {
      t1 += red_s[q * co + c];
      t2 += red_s[blockDim.x + q * co + c];
    }
    float* dst = partial + ((size_t)b * n_tiles + tile) * 2 * co;
    dst[c] = t1;
    dst[co + c] = t2;
  }
}

// stats[b, k] = sum over tiles of partial[b, tile, k] (k = stat * co + c),
// in a fixed order: thread (part, k) adds tiles part, part + nparts, ...;
// then the parts in order.
__global__ void __launch_bounds__(STATS_THREADS)
fused_stem_k1_stats_kernel(const float* __restrict__ partial, float* __restrict__ stats, int n_tiles, int n) {
  __shared__ float red_s[STATS_THREADS];
  const int b = blockIdx.x, nparts = STATS_THREADS / n, k = threadIdx.x % n, part = threadIdx.x / n;
  float s = 0.f;
  if (part < nparts) {
    const float* p = partial + (size_t)b * n_tiles * n + k;
#pragma unroll 4
    for (int i = part; i < n_tiles; i += nparts) s += p[(size_t)i * n];
  }
  red_s[threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.x < n) {
    float t = 0.f;
    for (int q = 0; q < nparts; ++q) t += red_s[q * n + k];
    stats[(size_t)b * n + k] = t;
  }
}

// Dynamic shared memory of one block, in bytes (the wrapper checks it too).
static int k1_smem_bytes(int ci, int co, int th, int tw) {
  const int x_floats = (th + 4) * (tw + 4) * odd_stride(ci), y2_floats = th * tw * co;
  return ((x_floats > y2_floats ? x_floats : y2_floats) + (th + 2) * (tw + 2) * odd_stride(co) + 2 * K1_THREADS) * 4;
}

template <bool DROP>
static int launch(const void* x, const void* bits, const void* fchan, const void* scal, const void* w1,
                  const void* b1, const void* w2, const void* b2, void* y2, void* partial, int B, int H, int W,
                  int ci, int co, int th, int tw, int t_keep, float inv_e, cudaStream_t stream) {
  const int smem = k1_smem_bytes(ci, co, th, tw);
  auto kern = fused_stem_k1_kernel<DROP>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(cdiv(H, th) * cdiv(W, tw), B), K1_THREADS, smem, stream>>>(
      (const float*)x, (const uint8_t*)bits, (const float*)fchan, (const int*)scal, (const float*)w1, (const float*)b1,
      (const float*)w2, (const float*)b2, (float*)y2, (float*)partial, H, W, ci, co, th, tw, t_keep, inv_e);
  return (int)cudaGetLastError();
}


// ---- bfloat16: the persistent strip walk

// k5a:: (the strip, the rings and the shared-memory layout) is in fused_stem_layout.h.

template <int CO, int KC1>
__global__ void __launch_bounds__(CONS_THREADS + PROD_THREADS, min_blocks(CO))
fused_stem_k1_tma(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tbits,
                  const __grid_constant__ CUtensorMap ty2, const bf16* __restrict__ w1op,
                  const bf16* __restrict__ w2op, const bf16* __restrict__ b1, const bf16* __restrict__ b2,
                  const float* __restrict__ fchan, const int* __restrict__ scal, float* __restrict__ partial, int B,
                  int H, int W, int R, int n_strips, int n_seg, int seg_len, int has_drop, int t_keep, float inv_e) {
  using namespace hopper;
  using namespace k5a;
  constexpr bool CI1 = KC1 == 0;  // ci == 1; else ci = 16 KC1
  constexpr int CI = CI1 ? 1 : 16 * KC1;
  constexpr int NJ = CO / 8;  // 8-column groups of an accumulator
  constexpr int NA = CO / 2;  // its registers
  // the 1024-byte aligned base, as an offset into the shared array: a pointer rebuilt from an integer would
  // lose its state space and turn every access of the tiles into a generic one
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024u - (hopper::smem_u32(smem_raw) & 1023u)) & 1023u);
  const Layout L = layout(CI, CO, R, has_drop);
  const SiteDrop d{has_drop ? scal[0] : 0, has_drop ? scal[1] : 0, t_keep, inv_e};
  const bool bits_on = d.use_elem && (d.pos == 1 || d.pos == 2);

  copy_to_smem(sm, w1op, weight_bytes(CI, CO));
  copy_to_smem(sm + L.w2, w2op, weight_bytes(CO, CO));
  unsigned char* reg = sm + L.wbytes;  // the consumer's region
  // h1's last two columns feed only discarded outputs: zero them once
  for (int i = threadIdx.x; i < 3 * L.h1_slot / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(reg + L.h1)[i] = make_uint4(0u, 0u, 0u, 0u);
  uint64_t* xfull = reinterpret_cast<uint64_t*>(reg + L.bar);
  uint64_t* xempty = xfull + NST;
  uint64_t* bfull = xfull + 2 * NST;
  uint64_t* bempty = bfull + NBS;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(&xfull[s], 1);   // the producer's arrival and the TMA bytes
      mbar_init(&xempty[s], 1);  // the consumer's thread 0, once the stage's rows are read
    }
    for (int s = 0; s < NBS; ++s) {
      mbar_init(&bfull[s], 1);
      mbar_init(&bempty[s], CONS_THREADS);  // every consumer thread
    }
    fence_barrier_init();
  }
  fence_proxy_async();  // the weights and zeros, written by threads, are read by wgmma
  __syncthreads();

  const int n_units = B * n_seg * n_strips;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int XPITCH = CI1 ? XW1 * 2 : XW * 16;  // bytes between the rows of a stage (of a plane)

  if (warp == 4) {
    // ---- producer: one lane issues the loads, in the order the consumer reads them
    if (lane != 0) return;
    const uint32_t x_bytes = CI1 ? R * XW1 * 2 : CI / 8 * R * XW * 16;
    int xs = 0, bs = 0;
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const Unit t = unit_of(u, n_strips, n_seg, seg_len, H);
      const int c0 = t.strip * STRIP, xa = t.r0 - 2, ns = cdiv(t.r1 - t.r0 + 4, R);
      int issued = 0;
      auto issue_x = [&](int last_row) {  // the stages through x row last_row
        const int need = min(ns, (last_row - xa) / R + 1);
        for (; issued < need; ++issued, ++xs) {
          const int s = xs % NST;
          mbar_wait(&xempty[s], ((xs / NST) & 1) ^ 1);
          mbar_arrive_expect_tx(&xfull[s], x_bytes);
          unsigned char* dst = reg + L.x + s * L.x_stage;
          const int row = xa + issued * R;
          if (CI1) {
            tma_load_3d(dst, &tx, &xfull[s], (c0 - 2) & ~7, row, t.b);
          } else {
#pragma unroll
            for (int g = 0; g < CI / 8; ++g) tma_load_4d(dst + g * L.x_plane, &tx, &xfull[s], 8 * g, c0 - 2, row, t.b);
          }
        }
      };
      issue_x(t.r0);
      for (int y = t.r0 - 1; y <= t.r1; ++y) {  // the consumer's rows
        if (bits_on && (d.pos == 1 || y - 1 >= t.r0)) {  // site 1: h1 row y; site 2: y2 row y - 1
          const int s = bs % NBS;
          mbar_wait(&bempty[s], ((bs / NBS) & 1) ^ 1);
          mbar_arrive_expect_tx(&bfull[s], 64 * CO);
          tma_load_4d(reg + L.bits + s * 64 * CO, &tbits, &bfull[s], 0, d.pos == 1 ? c0 - 1 : c0,
                      d.pos == 1 ? y : y - 1, t.b);
          ++bs;
        }
        if (y + 1 <= t.r1) issue_x(y + 2);
      }
    }
    return;
  }

  // ---- consumer: a warpgroup; thread rows m_a and m_a + 8 of the 64, channels 8j + 2tq + e
  const int tid = threadIdx.x & 127, w = tid >> 5, g = lane >> 2, tq = lane & 3, m_a = 16 * w + g;
  constexpr int bar_id = 1;
  const uint32_t w1a = smem_u32(sm), w2a = smem_u32(sm + L.w2), rega = smem_u32(reg);
  float bias1[2 * NJ], bias2[2 * NJ], fch[2 * NJ], s1[2 * NJ], s2[2 * NJ];
#pragma unroll
  for (int i = 0; i < 2 * NJ; ++i) {
    const int n = 8 * (i >> 1) + 2 * tq + (i & 1);
    bias1[i] = __bfloat162float(b1[n]);
    bias2[i] = __bfloat162float(b2[n]);
    s1[i] = s2[i] = 0.f;
  }
  float acc1[NA], acc2[NA], acc2p[NA];
  int xs_base = 0, bs = 0, stg_n = 0;
  PendingRow pend{0, 0, 0, 0, 0};

  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    const Unit t = unit_of(u, n_strips, n_seg, seg_len, H);
    const int c0 = t.strip * STRIP, xa = t.r0 - 2, ns = cdiv(t.r1 - t.r0 + 4, R);
    int waited = 0, released = 0;
#pragma unroll
    for (int i = 0; i < 2 * NJ; ++i)
      fch[i] = (d.pos == 1 || d.pos == 2) && !d.use_elem ? __ldg(fchan + t.b * CO + 8 * (i >> 1) + 2 * tq + (i & 1))
                                                           : 1.f;

    // x rows by a cursor (stage of the unit, row in the stage), stepped a row at a time: no division a row
    auto x_off = [&](int st, int r) { return L.x + ((xs_base + st) % NST) * L.x_stage + r * XPITCH; };
    auto step = [&](int& st, int& r) {
      if (++r == R) {
        r = 0;
        ++st;
      }
    };
    auto wait_stage = [&](int st) {  // stages through st of the unit have landed
      for (; waited <= st; ++waited) mbar_wait(&xfull[(xs_base + waited) % NST], ((xs_base + waited) / NST) & 1);
    };
    // conv1 of one h1 row from x rows at offsets o0, o1, o2 (its rows - 1, + 0, + 1). ci == 1: its A,
    // A(m, tap) = x[tap / 3][m + tap % 3] (0 for the padding taps 9-15), is staged as two planes of
    // [64 pixels][8 taps] by stage_a1 (thread (half, m) writes one 16-byte row) before the barrier
    const int xo = (c0 - 2) & 7;  // ci == 1: column c0 - 2 in a loaded row
    auto stage_a1 = [&](int o0, int o1, int o2) {
      const int m = tid & 63, half = tid >> 6;
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t pair = 0u;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int tap = 8 * half + 2 * e + k;
          const int off = tap < 3 ? o0 : tap < 6 ? o1 : o2;  // taps 9-15 read row + 1 and drop it
          const uint32_t xv = *reinterpret_cast<const uint16_t*>(reg + off + 2 * (xo + m + tap % 3));
          pair |= (tap < 9 ? xv : 0u) << (16 * k);
        }
        v[e] = pair;
      }
      *reinterpret_cast<uint4*>(reg + L.a1 + half * 1024 + m * 16) = make_uint4(v[0], v[1], v[2], v[3]);
    };
    auto conv1 = [&](int o0, int o1, int o2) {
      wgmma_fence();
      if constexpr (CI1) {
        Wgmma<CO>::ss(acc1, plain_desc(rega + L.a1, 1024, 128), plain_desc(w1a, 16 * CO, 128), 0);
      } else {
        const int o[3] = {o0, o1, o2};
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
            for (int kc = 0; kc < KC1; ++kc)
              Wgmma<CO>::ss(acc1, plain_desc(rega + o[dy] + 2 * kc * L.x_plane + 16 * dx, L.x_plane, 128),
                            plain_desc(w1a + ((dy * 3 + dx) * KC1 + kc) * 32 * CO, 16 * CO, 128),
                            (dy | dx | kc) != 0);
          }
        }
      }
      wgmma_commit();
    };
    // y2 rows from acc2p: relu(conv2 + b2) * site-2 factor (bits in bprev), rounded; staged for the
    // store, summed where valid
    bool prev = false;  // acc2p holds a y2 row still to finish
    const uint8_t* bprev = nullptr;
    int bslot_prev = 0;
    // one pair of channels of one of the thread's two rows (pair p: row half p / NJ, columns 8 (p % NJ) + 2tq)
    auto y2_pair = [&](int p) {
      const int hf = p / NJ, j = p % NJ, m = m_a + 8 * hf;
      unsigned char* st = reg + (stg_n & 1) * L.stg_row;
      const float2 f = pair_factor(d, 2, bprev + m * CO + 8 * j + 2 * tq, make_float2(fch[2 * j], fch[2 * j + 1]));
      const uint32_t v = pack_bf2(fmaxf(acc2p[4 * j + 2 * hf] + bias2[2 * j], 0.f) * f.x,
                                  fmaxf(acc2p[4 * j + 2 * hf + 1] + bias2[2 * j + 1], 0.f) * f.y);
      if (m < STRIP) *reinterpret_cast<uint32_t*>(st + stg_swizzle<CO>(m * CO * 2 + (8 * j + 2 * tq) * 2)) = v;
      if (m < STRIP && c0 + m < W) {
        const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
        s1[2 * j] += r.x;
        s2[2 * j] += r.x * r.x;
        s1[2 * j + 1] += r.y;
        s2[2 * j + 1] += r.y * r.y;
      }
    };
    auto y2_done = [&](int yy) {  // the row is staged: release its bits, queue its store
      if (bits_on && d.pos == 2) mbar_arrive(&bempty[bslot_prev]);
      pend = PendingRow{1, stg_n & 1, c0, yy, t.b};
      ++stg_n;
    };
    // y2 row y - 1 from h1 rows y - 2 .. y, in slots hs + 1, hs + 2, hs (mod 3) where hs holds row y
    auto slot3 = [](int s) { return s >= 3 ? s - 3 : s; };
    auto conv2 = [&](int hs) {
      wgmma_fence();
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const uint32_t base = rega + L.h1 + slot3(hs + 1 + dy) * L.h1_slot;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
          for (int kc = 0; kc < CO / 16; ++kc)
            Wgmma<CO>::ss(acc2, plain_desc(base + 2 * kc * HPW * 16 + 16 * dx, HPW * 16, 128),
                          plain_desc(w2a + ((dy * 3 + dx) * (CO / 16) + kc) * 32 * CO, 16 * CO, 128),
                          (dy | dx | kc) != 0);
        }
      }
      wgmma_commit();
    };

    // the cursor holds the first x row of the next conv1: x row r0 - 2 (unit row 0) for h1 row r0 - 1
    int cs = 0, cr = 0;
    {
      int s1c = cs, r1c = cr, s2c, r2c;
      step(s1c, r1c);
      s2c = s1c;
      r2c = r1c;
      step(s2c, r2c);
      wait_stage(s2c);
      if (t.r0 - 1 >= 0) {
        if (CI1) {
          stage_a1(x_off(cs, cr), x_off(s1c, r1c), x_off(s2c, r2c));
          fence_proxy_async();
          named_sync(bar_id, CONS_THREADS);
        }
        conv1(x_off(cs, cr), x_off(s1c, r1c), x_off(s2c, r2c));
        wgmma_wait<0>();
        fence_regs(acc1);
      }
      step(cs, cr);
    }
    int h_slot = 0;  // the h1 slot of row y: (y - r0 + 1) % 3
    for (int y = t.r0 - 1; y <= t.r1; ++y) {
      // conv1 of row y is done (and ci == 1's staging of it, before the last barrier): x rows below y are free
      for (; released < ns && xa + (released + 1) * R - 1 < y; ++released)
        if (tid == 0) mbar_arrive(&xempty[(xs_base + released) % NST]);
      const uint8_t* brow = nullptr;
      int bslot = 0;
      if (bits_on && (d.pos == 1 || y - 1 >= t.r0)) {
        bslot = bs % NBS;
        mbar_wait(&bfull[bslot], (bs / NBS) & 1);
        brow = reg + L.bits + bslot * 64 * CO;
        ++bs;
      }
      {  // h1 row y into its slot: 0 outside the image, relu(conv1 + b1) * site-1 factor inside
        unsigned char* hs = reg + L.h1 + h_slot * L.h1_slot;
        const bool rowin = y >= 0 && y < H;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int m = m_a + 8 * hf, col = c0 - 1 + m;
          const bool in = rowin && col >= 0 && col < W;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            uint32_t v = 0u;
            if (in) {
              const float2 f = pair_factor(d, 1, brow + m * CO + 8 * j + 2 * tq, make_float2(fch[2 * j], fch[2 * j + 1]));
              v = pack_bf2(fmaxf(acc1[4 * j + 2 * hf] + bias1[2 * j], 0.f) * f.x,
                           fmaxf(acc1[4 * j + 2 * hf + 1] + bias1[2 * j + 1], 0.f) * f.y);
            }
            *reinterpret_cast<uint32_t*>(hs + j * HPW * 16 + m * 16 + 4 * tq) = v;
          }
        }
      }
      if (bits_on && d.pos == 1) mbar_arrive(&bempty[bslot]);
      const bool two = y - 1 >= t.r0, next = y + 1 <= t.r1, one = next && y + 1 < H;
      // the x rows y .. y + 2 of conv1(y + 1)
      int s1c = cs, r1c = cr, s2c, r2c;
      step(s1c, r1c);
      s2c = s1c;
      r2c = r1c;
      step(s2c, r2c);
      const int o0 = x_off(cs, cr), o1 = x_off(s1c, r1c), o2 = x_off(s2c, r2c);
      if (next) wait_stage(s2c);
      if (CI1 && one) stage_a1(o0, o1, o2);
      fence_proxy_async();
      if (tid == 0) bulk_wait_read();  // earlier stores have read their staging rows
      named_sync(bar_id, CONS_THREADS);
      if (tid == 0 && pend.on) {
        tma_store_4d(&ty2, reg + pend.buf * L.stg_row, 0, pend.col, pend.row, pend.b);
        bulk_commit();
      }
      pend.on = 0;
      if (two) conv2(h_slot);
      if (one) conv1(o0, o1, o2);
      // y2 row y - 2 from the copy of its accumulator while this row's products run: after their issue
      // (pairs interleaved between the taps' products ran 20% slower)
      if (prev) {
#pragma unroll
        for (int p = 0; p < 2 * NJ; ++p) y2_pair(p);
        y2_done(y - 2);
      }
      // both products retire before either accumulator is read: reading one while the other is in flight
      // (wgmma_wait<1>) made ptxas serialize every wgmma of the kernel
      wgmma_wait<0>();
      fence_regs(acc1);
      fence_regs(acc2);
      prev = two;
      if (two) {
#pragma unroll
        for (int i = 0; i < NA; ++i) acc2p[i] = acc2[i];
        bprev = brow;
        bslot_prev = bslot;
      }
      step(cs, cr);
      h_slot = slot3(h_slot + 1);
    }
    if (prev) {  // the unit's last y2 row, after a barrier that lets its staging row be rewritten
      fence_proxy_async();
      if (tid == 0) bulk_wait_read();
      named_sync(bar_id, CONS_THREADS);
      if (tid == 0 && pend.on) {
        tma_store_4d(&ty2, reg + pend.buf * L.stg_row, 0, pend.col, pend.row, pend.b);
        bulk_commit();
      }
      pend.on = 0;
#pragma unroll
      for (int p = 0; p < 2 * NJ; ++p) y2_pair(p);
      y2_done(t.r1 - 1);
    }
    for (; released < ns; ++released)
      if (tid == 0) mbar_arrive(&xempty[(xs_base + released) % NST]);
    xs_base += ns;

    // the unit's statistics: the 8 row lanes, then the 4 warps, in a fixed order
    float* red = reinterpret_cast<float*>(reg + L.red);
#pragma unroll
    for (int i = 0; i < 2 * NJ; ++i) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], o);
        s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], o);
      }
      if (g == 0) {
        const int n = 8 * (i >> 1) + 2 * tq + (i & 1);
        red[(2 * w) * CO + n] = s1[i];
        red[(2 * w + 1) * CO + n] = s2[i];
      }
      s1[i] = s2[i] = 0.f;
    }
    named_sync(bar_id, CONS_THREADS);
    if (tid < 2 * CO) {
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) v += red[(2 * q + tid / CO) * CO + tid % CO];
      partial[(size_t)u * 2 * CO + tid] = v;
    }
  }
  fence_proxy_async();
  if (tid == 0) bulk_wait_read();
  named_sync(bar_id, CONS_THREADS);
  if (tid == 0) {
    if (pend.on) {
      tma_store_4d(&ty2, reg + pend.buf * L.stg_row, 0, pend.col, pend.row, pend.b);
      bulk_commit();
    }
    bulk_wait();
  }
}

template <int CO, int KC1>
static int launch_tma(const void* x, const void* bits, const void* fchan, const void* scal, const void* w1op,
                      const void* b1, const void* w2op, const void* b2, void* y2, void* partial, int B, int H, int W,
                      int R, int grid, int seg_len, int has_drop, int t_keep, float inv_e, cudaStream_t stream) {
  using namespace k5a;
  constexpr int CI = KC1 == 0 ? 1 : 16 * KC1;
  CUtensorMap tx, tb, ty;
  memset(&tb, 0, sizeof(tb));
  int err;
  if (KC1 == 0) {  // x [B, H, W] with 2-byte pixels in rows of align_up(W, 8): (W, H, B), a box of XW1 x R
    const uint64_t pitch = (uint64_t)align_up(W, 8) * 2;  // a map's strides are multiples of 16 bytes
    const uint64_t dims[3] = {(uint64_t)W, (uint64_t)H, (uint64_t)B};
    const uint64_t strides[2] = {pitch, H * pitch};
    const uint32_t box[3] = {(uint32_t)XW1, (uint32_t)R, 1};
    err = hopper::make_map_nd(&tx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, dims, strides, box,
                              CU_TENSOR_MAP_SWIZZLE_NONE);
  } else {  // a plane of 8 channels x XW columns x R rows
    err = make_nhwc_map(&tx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, B, H, W, CI, 8, XW, R,
                        CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (!err && has_drop)
    err = make_nhwc_map(&tb, bits, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, B, H, W, CO, CO, 64, 1, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!err)
    err = make_nhwc_map(&ty, y2, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, B, H, W, CO, CO, STRIP, 1, stg_swizzle_mode(CO));
  if (err) return err;
  const int smem = layout(CI, CO, R, has_drop).total;
  auto kern = fused_stem_k1_tma<CO, KC1>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int n_strips = cdiv(W, STRIP), n_seg = cdiv(H, seg_len);
  kern<<<grid, CONS_THREADS + PROD_THREADS, smem, stream>>>(
      tx, tb, ty, (const bf16*)w1op, (const bf16*)w2op, (const bf16*)b1, (const bf16*)b2, (const float*)fchan,
      (const int*)scal, (float*)partial, B, H, W, R, n_strips, n_seg, seg_len, has_drop, t_keep, inv_e);
  return (int)cudaGetLastError();
}

template <int CO>
static int launch_bf16(int ci, const void* x, const void* bits, const void* fchan, const void* scal,
                       const void* w1op, const void* b1, const void* w2op, const void* b2, void* y2, void* partial,
                       int B, int H, int W, int R, int grid, int seg_len, int has_drop, int t_keep, float inv_e,
                       cudaStream_t stream) {
#define K1_TMA_ARGS x, bits, fchan, scal, w1op, b1, w2op, b2, y2, partial, B, H, W, R, grid, seg_len, has_drop, t_keep, inv_e, stream
  switch (ci) {
    case 1: return launch_tma<CO, 0>(K1_TMA_ARGS);
    case 16: return launch_tma<CO, 1>(K1_TMA_ARGS);
    case 32: return launch_tma<CO, 2>(K1_TMA_ARGS);
    case 64: return launch_tma<CO, 4>(K1_TMA_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef K1_TMA_ARGS
}

// dtype 0 float32 (CUDA cores: tiles of rows x tw, partial [B, n_tiles, 2,
// co]); 1 bfloat16 (the strip walk: w1op/w2op the weights' wgmma operands,
// `rows` x rows a stage, what fused_stem_k1_fit takes; `grid` blocks,
// segments of seg_len rows, partial [B, n_seg * ceil(W / 62), 2, co]; at ci
// 1, x rows of align_up(W, 8) pixels). x [B, H, W, ci], bits [B, H, W, co]
// (null without dropout), fchan [B, co], scal int32 {pos, use_elem} on the
// device, stats [B, 2, co].
extern "C" int fused_stem_k1_launch(const void* x, const void* bits, const void* fchan, const void* scal,
                                    const void* w1, const void* w1op, const void* b1, const void* w2,
                                    const void* w2op, const void* b2, void* y2, void* partial, void* stats,
                                    int dtype, int has_drop, int B, int H, int W, int ci, int co, int rows, int tw,
                                    int grid, int seg_len, int t_keep, float inv_e, void* stream) {
  if (co % OCB || K1_THREADS % co || 2 * co > STATS_THREADS || rows < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err, n_tiles;
  if (dtype == 0) {
    if (k1_smem_bytes(ci, co, rows, tw) > SMEM_MAX) return (int)cudaErrorInvalidValue;
    err = has_drop ? launch<true>(x, bits, fchan, scal, w1, b1, w2, b2, y2, partial, B, H, W, ci, co, rows, tw, t_keep,
                                  inv_e, s)
                   : launch<false>(x, bits, fchan, scal, w1, b1, w2, b2, y2, partial, B, H, W, ci, co, rows, tw,
                                   t_keep, inv_e, s);
    n_tiles = cdiv(H, rows) * cdiv(W, tw);
  } else if (dtype == 1) {
    int fit[5];
    if (fused_stem_k1_fit(ci, co, rows, has_drop, fit) != STEM_FIT_OK || grid < 1 || seg_len < 1)
      return (int)cudaErrorInvalidValue;
#define K1_BF16_ARGS \
  ci, x, bits, fchan, scal, w1op, b1, w2op, b2, y2, partial, B, H, W, rows, grid, seg_len, has_drop, t_keep, \
      inv_e, s
    err = co == 16 ? launch_bf16<16>(K1_BF16_ARGS) : co == 32 ? launch_bf16<32>(K1_BF16_ARGS) : launch_bf16<64>(K1_BF16_ARGS);
#undef K1_BF16_ARGS
    n_tiles = cdiv(H, seg_len) * cdiv(W, k5a::STRIP);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  fused_stem_k1_stats_kernel<<<B, STATS_THREADS, 0, s>>>((const float*)partial, (float*)stats, n_tiles, 2 * co);
  return (int)cudaGetLastError();
}
