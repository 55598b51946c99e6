"""K4's arithmetic and walk, and K1c's launch plan, on the CPU.

- The keep-mask as K4 (csrc/keep_mask.cu) computes it, emulated step for
  step in numpy uint32: the column terms fold16(col * COL_MUL) of a lane's
  16 keys and the row term fold16(mix ^ row * ROW_MUL) hoisted, one xor a
  byte, the finalizer's first multiply and its y ^= y >> 13, the second
  multiply, the last fold moved onto the threshold (y ^ (thresh >> 16)),
  the compare as the carry of y + (2^32 - thresh) (every byte keeps at
  rate 0) and the bytes packed four to a word by w = w * 256 + carry from
  the highest byte down, written little-endian. It must equal the JAX
  package's ``export_keep_masks`` in interpret mode bit for bit, at seeds
  of both signs, rates 0 to 0.9, the decoder's (128, 2048) and the self
  shape's (128, 1280) mask geometries, with keys over several k-blocks.
- K4's walk (csrc/keep_mask_plan.h, built by the host's C++ compiler):
  every lane of every warp of a persistent grid writes each (row, 16-key
  group) of the mask once, with the (batch, head, query) of its row, at
  random shapes, grids and mask q-blocks, more than 65,535 query rows
  among them.
- K1c's blocks and consumer warpgroups (csrc/k1c_plan.h and
  csrc/flash_band.h, the same builds): the key tiles a block walks
  (key_tiles), the tiles each of its consumers runs (tile_meets_band) and
  the score test (in_band) visit each (query, key) pair of the causal
  band once, and no other, for windows about the tile and block sizes and
  full causal; its 1-D grid (k1c::block) takes each (query tile, batch
  row, head) once, in its order.
- What ``keep_mask_cuda`` refuses before it launches, and that its keys a
  lane are K4's.
"""

import ctypes

import numpy as np
import pytest
import torch

from omr_a2s_multimodal_transformer_tpu.ops.flash_packed import export_keep_masks as j_export
from omr_a2s_multimodal_transformer_tpu_torch.ops import cuda_build
from omr_a2s_multimodal_transformer_tpu_torch.ops import flash_packed as tflash

U32 = np.uint32
KEYS = 16  # keys a lane writes to a row (csrc/keep_mask_plan.h)


def _fold16(x):
    return x ^ (x >> U32(16))


def _k4_emulated(seed, batch, heads, lq, lk, rate, block_q, block_k):
    """[B, H, Lq_p, Lk_p] bool: the keep-mask as K4's instructions compute it."""
    bq, bk = tflash.mask_geometry(lq, lk, block_q, block_k)
    lq_p, lk_p = -(-lq // bq) * bq, -(-lk // bk) * bk
    thresh = tflash.dropout_threshold(rate)
    t_hi, neg_thresh = U32(thresh >> 16), U32((-thresh) & 0xFFFFFFFF)
    q, k = np.arange(lq_p, dtype=U32), np.arange(lk_p, dtype=U32)
    with np.errstate(over="ignore"):
        col = _fold16((k % U32(bk)) * U32(2246822519))  # a lane's column terms, hoisted
        out = np.empty((batch, heads, lq_p, lk_p), dtype=np.uint8)
        for b in range(batch):
            for h in range(heads):
                mix = (U32(seed & 0xFFFFFFFF) ^ U32((b * 1000003) & 0xFFFFFFFF)
                       ^ ((q // U32(bq)) * U32(7919))[:, None] ^ ((k // U32(bk)) * U32(104729))[None, :])
                mix = mix * U32(2654435761)                                     # block_mix
                row = (U32(h * bq) + q % U32(bq)) * U32(40503)
                a = _fold16(mix ^ row[:, None])                                 # the folded row term
                y = (a ^ col[None, :]) * U32(0x85EBCA6B)
                y = y ^ (y >> U32(13))
                z = (y * U32(0xC2B2AE35)) ^ t_hi                                # the last fold, on the threshold
                carry = (z.astype(np.uint64) + np.uint64(neg_thresh)) >> np.uint64(32)
                carry = np.ones_like(carry) if thresh == 0 else carry           # rate 0: every byte keeps
                w = np.zeros((lq_p, lk_p // 4), dtype=U32)
                for i in (3, 2, 1, 0):                                          # w = w * 256 + carry, byte 3 first
                    w = w * U32(256) + carry[:, i::4].astype(U32)
                out[b, h] = w.astype("<u4").view(np.uint8).reshape(lq_p, lk_p)
    return out.astype(bool)


@pytest.mark.parametrize("case", [
    # (seed, batch, heads, lq, lk, rate, block_q, block_k): the decoder's 128/2048 blocks over 2 k-blocks,
    # the self shape's (128, 1280) over 3, and 128/512 over 5
    (7, 1, 2, 200, 4000, 0.1, 128, 2048),
    (-12345, 2, 1, 130, 2100, 0.5, 128, 2048),
    (20240611, 1, 2, 150, 2600, 0.9, 128, 1280),
    (-1, 1, 1, 100, 3000, 0.1, 128, 1280),
    (1268100, 1, 2, 256, 2500, 0.0, 128, 512),
    (3, 2, 2, 140, 600, 0.3, 128, 128),
], ids=lambda c: f"s{c[0]}_q{c[3]}_k{c[4]}_r{c[5]}_bk{c[7]}")
def test_k4_arithmetic_bits_equal_jax(case):
    seed, batch, heads, lq, lk, rate, block_q, block_k = case
    ref = np.asarray(j_export(seed, batch, heads, lq, lk, dropout_rate=rate, block_q=block_q, block_k=block_k,
                              interpret=True))
    got = _k4_emulated(seed, batch, heads, lq, lk, rate, block_q, block_k)
    assert got.shape == ref.shape and got.shape[-1] > tflash.mask_geometry(lq, lk, block_q, block_k)[1]
    np.testing.assert_array_equal(got, ref)


def _walk_counts(batch, heads, lq_p, lk_p, mbq, workers):
    lib = cuda_build.host_library("keep_mask_plan")
    counts = np.zeros((batch * heads * lq_p, lk_p // KEYS), dtype=np.uint8)
    fn = lib.keep_mask_walk_counts
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int64
    wrong = fn(batch, heads, lq_p, lk_p, mbq, workers, counts.ctypes.data)
    return counts, wrong


@pytest.mark.parametrize("shape", [
    # (B, H, Lq_p, Lk_p, mbq, warps): the cross shape's mask with the default grid (132 SMs x 4 blocks x 8
    # warps); more query rows than a grid dimension holds, at B = H = 1 and at B x H = 3; rows in one strip
    # (Lk_p < 512) and a ragged last strip; more warps than units, and one warp
    (8, 4, 1280, 14336, 128, 4224),
    (1, 1, 70016, 128, 128, 4224),
    (1, 3, 65664, 48, 128, 777),
    (2, 3, 384, 1040, 128, 100),
    (3, 1, 512, 16, 256, 5000),
    (2, 2, 256, 1536, 128, 1),
])
def test_k4_walk_writes_each_group_once(shape):
    batch, heads, lq_p, lk_p, mbq, workers = shape
    counts, wrong = _walk_counts(batch, heads, lq_p, lk_p, mbq, workers)
    assert wrong == 0
    assert counts.min() == 1 and counts.max() == 1


def test_k4_walk_at_random_shapes():
    rng = np.random.default_rng(12)
    for _ in range(20):
        mbq = int(rng.choice([128, 256]))
        batch, heads = int(rng.integers(1, 4)), int(rng.integers(1, 5))
        lq_p, lk_p = mbq * int(rng.integers(1, 6)), KEYS * int(rng.integers(1, 200))
        counts, wrong = _walk_counts(batch, heads, lq_p, lk_p, mbq, int(rng.integers(1, 3000)))
        assert wrong == 0 and counts.min() == 1 and counts.max() == 1, (batch, heads, lq_p, lk_p, mbq)


@pytest.mark.parametrize("window", [1, 63, 64, 65, 100, 191, 192, -1])
@pytest.mark.parametrize("length", [400, 130])
def test_k1c_blocks_cover_the_band_once(window, length):
    """K1c's blocks of k1c::CONSUMERS x 64 queries, the key tiles each walks
    and the tiles each consumer runs visit every (query, key) pair of the
    band once, with the kernels' own band functions."""
    lib = cuda_build.host_library("flash_band")
    consumers = cuda_build.host_library("k1c_plan").k1c_plan_consumers()
    rows, n_tiles = 64 * consumers, -(-length // 64)
    visits = np.zeros((length, length), dtype=np.int64)
    lo_hi = (ctypes.c_int * 2)()
    for qt in range(-(-length // rows)):
        lib.flash_band_key_tiles(qt * rows, n_tiles, window, rows, lo_hi)
        for c in range(consumers):
            q0 = qt * rows + 64 * c
            for kt in range(lo_hi[0], lo_hi[1] + 1):
                if not lib.flash_band_tile_meets_band(q0, kt * 64, window):
                    continue
                for q in range(q0, min(q0 + 64, length)):
                    for k in range(kt * 64, min(kt * 64 + 64, length)):
                        visits[q, k] += lib.flash_band_in_band(q, k, window)
    qpos, kpos = np.arange(length)[:, None], np.arange(length)[None, :]
    band = kpos <= qpos
    if window > 0:
        band &= kpos >= qpos - window
    np.testing.assert_array_equal(visits, band.astype(np.int64))


@pytest.mark.parametrize("window", [100, -1])
def test_k1c_grid_takes_each_block_once(window):
    """K1c's 1-D grid (k1c::block): every (query tile, batch row, head) once;
    with a window a (batch row, head)'s query tiles side by side, without
    it the last query tiles of all of them first."""
    lib = cuda_build.host_library("k1c_plan")
    n_qt, batch, heads = 7, 8, 4
    out = (ctypes.c_int * 3)()
    order = []
    for i in range(n_qt * batch * heads):
        lib.k1c_plan_block(i, n_qt, batch, heads, window, out)
        order.append(tuple(out))
    assert sorted(order) == [(qt, b, h) for qt in range(n_qt) for b in range(batch) for h in range(heads)]
    if window > 0:
        assert [qt for qt, _, _ in order[:n_qt]] == list(range(n_qt)) and len({o[1:] for o in order[:n_qt]}) == 1
    else:
        assert [qt for qt, _, _ in order] == sorted((qt for qt, _, _ in order), reverse=True)


def test_keep_mask_cuda_refuses_what_the_kernel_does_not_take():
    """A mask k-block or Lk_p off K4's 16 keys a lane, or an Lq_p off the
    q block or no q block: ValueError before any launch (on any device)."""
    seed = torch.zeros(1, dtype=torch.int32)
    n = tflash.keep_mask_cuda.launches
    for args, match in (((1, 4, 128, 520, 0.1, 128, 520), "multiples of it"),
                        ((1, 4, 128, 504, 0.1, 128, 2048), "multiples of it"),
                        ((1, 4, 200, 512, 0.1, 128, 512), "multiple of the q block"),
                        ((1, 4, 128, 512, 0.1, 0, 512), "multiple of the q block")):
        with pytest.raises(ValueError, match=match):
            tflash.keep_mask_cuda(seed, *args)
    assert tflash.keep_mask_cuda.launches == n


def test_keep_mask_cuda_checks_the_kernels_keys_a_lane():
    """The wrapper checks the geometry for the kernel (its launcher does
    not), with K4's own keys a lane (csrc/keep_mask_plan.h km::KEYS)."""
    assert tflash.KEEP_MASK_KEYS == KEYS == cuda_build.host_library("keep_mask_plan").keep_mask_keys()
