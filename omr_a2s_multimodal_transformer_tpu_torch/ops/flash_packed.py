"""Head-packed flash attention with attention-weight dropout.

Port of ``omr_a2s_multimodal_transformer_tpu/ops/flash_packed.py``. q is
[B, Lq, H*64] and k/v are [B, Lk, H*64]; per head h,

    o = (softmax(q_h k_h^T / sqrt(64)) * M / (1 - rate)) v_h

with keys masked where ``kv_valid`` is False or ``k >= kv_len`` and, for a
causal call, where k > q or (window > 0) k < q - window (their score
becomes -1e30), and M the dropout keep-mask, applied after the softmax
(torch MHA semantics).

Two routes, chosen by where the tensors lie, never by a switch:

- CUDA tensors go through ``FlashAttention`` (a ``torch.autograd.Function``)
  whose forward launches kernel K1 (non-causal: wgmma and TMA, its keys in
  ``fwd_splits`` chunks merged by lse) or K1c (causal, optionally windowed:
  K1's block with the causal band, ``causal_fwd_plan``; both
  ``csrc/flash_fwd.cu``) and whose backward launches K2
  (``csrc/flash_bwd.cu``, the merged backward of a non-causal call) or K3a
  then K3b (``csrc/flash_dq.cu``, its keys in ``dq_splits`` chunks summed
  in order, and ``csrc/flash_dkv.cu``, K2's block without dq: the split
  backward of every other call), as the JAX backward chooses. ``export_keep_masks``
  launches K4 (``csrc/keep_mask.cu``, a persistent walk of row strips,
  ``csrc/keep_mask_plan.h``). There is no fallback: a kernel that
  does not build or launch raises.
- CPU tensors go through ``flash_attention_plain``, the same function as
  dense masked softmax in PyTorch, differentiated by autograd, and
  ``keep_mask``.

The keep-mask is a pure function of (seed, b, h, q, k): the counter hash
of the JAX kernel's interpret mode evaluated on global indices at the
caller's JAX mask geometry (``mask_geometry``: the decoder's 128/2048, or
the blocks given to ``make_flash_attention_packed``). Both routes
therefore apply the masks that ``export_keep_masks(..., interpret=True)``
of the JAX package returns, bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from omr_a2s_multimodal_transformer_tpu_torch.device import DeviceLike, resolve_device
from omr_a2s_multimodal_transformer_tpu_torch.ops import cuda_build

NEG_INF = -1e30
HEAD_DIM = 64
KERNEL_TILE = 64  # rows per tile in the CUDA flash kernels
MASK_BQ, MASK_BK = 128, 2048  # the decoder's JAX block sizes, which seed its keep-mask hash
KEEP_MASK_KEYS = 16  # keys a lane writes to a row (one 16-byte store) in K4: csrc/keep_mask_plan.h KEYS
LOG2E = 1.4426950408889634
_U32 = 0xFFFFFFFF


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def mask_geometry(lq: int, lk: int, block_q: int = MASK_BQ, block_k: int = MASK_BK) -> Tuple[int, int]:
    """(bq, bk) blocks of the JAX kernel called with (block_q, block_k) at
    (lq, lk), rounded as its ``_shapes``: the keep-mask hash is seeded per
    block of this geometry. The defaults are the decoder's call."""
    return min(block_q, _round_up(lq, 128)), min(block_k, _round_up(lk, 128))


def band_window(causal: bool, window: int) -> int:
    """The window a call applies: JAX limits keys to k >= q - window only
    for a causal call with window > 0; every other call has none (-1)."""
    return window if causal and window > 0 else -1


def dropout_threshold(rate: float) -> int:
    """Keep where the 32-bit hash is >= this (as in the JAX kernel)."""
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 tensors holding uint32 values, without
    overflowing int64: split c into 16-bit halves."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def keep_mask(seed: int, batch: int, n_heads: int, lq: int, lk: int, rate: float, device=None,
              block_q: int = MASK_BQ, block_k: int = MASK_BK) -> torch.Tensor:
    """[B, H, Lq, Lk] bool keep-mask of the flash kernels (True = keep), at
    the mask geometry of (block_q, block_k); plain version of K4."""
    bq, bk = mask_geometry(lq, lk, block_q, block_k)
    thresh = dropout_threshold(rate)
    qpos = torch.arange(lq, device=device, dtype=torch.int64)
    kpos = torch.arange(lk, device=device, dtype=torch.int64)
    heads = torch.arange(n_heads, device=device, dtype=torch.int64)
    row = (heads[:, None] * bq + (qpos % bq)[None, :]) & _U32           # [H, Lq]
    row_term = _mul32(row, 40503)[:, :, None]                             # [H, Lq, 1]
    col_term = _mul32(kpos % bk, 2246822519)[None, None, :]               # [1, 1, Lk]
    qi, kb = qpos // bq, kpos // bk
    out = []
    for b in range(batch):
        mix = (seed & _U32) ^ ((b * 1000003) & _U32) ^ ((qi * 7919) & _U32)[:, None] ^ ((kb * 104729) & _U32)[None, :]
        x = _mul32(mix, 2654435761)[None] ^ row_term ^ col_term          # [H, Lq, Lk]
        x = x ^ (x >> 16)
        x = _mul32(x, 0x85EBCA6B)
        x = x ^ (x >> 13)
        x = _mul32(x, 0xC2B2AE35)
        x = x ^ (x >> 16)
        out.append(x >= thresh)
    return torch.stack(out)


def _keep_den(rate: float) -> float:
    # the JAX kernel divides by (1 - rate) rounded to float32
    return float(np.float32(1.0 - rate))


def _keep_scale(rate: float) -> float:
    # the CUDA kernels multiply by its float32 reciprocal (within an ulp of the division)
    return float(np.float32(1.0) / np.float32(1.0 - rate))


def _heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, l, pd = x.shape
    return x.reshape(b, l, n_heads, pd // n_heads).transpose(1, 2)


def flash_attention_plain(q, k, v, kv_len, kv_valid, seed, dropout_rate: float = 0.0, n_heads: int = 4,
                          causal: bool = False, window: int = -1, block_q: int = MASK_BQ, block_k: int = MASK_BK):
    """Plain PyTorch version of K1 and K1c (autograd gives the function of
    K2, K3a and K3b).

    Returns (o [B, Lq, H*Dh] in q's dtype, lse [B, H, Lq] f32). Scores,
    softmax and dropout are float32; p is rounded to the input dtype before
    the PV product, as the kernels do. The keep-mask is that of the mask
    geometry of (block_q, block_k). A row with no key to see averages v over
    the Lk keys (no NaN); the JAX kernel averages over the keys of the
    blocks it ran, the CUDA kernels over their 64-key tiles.
    """
    b, lq, pd = q.shape
    lk = k.shape[1]
    dh = pd // n_heads
    qh, kh, vh = (_heads(t.float(), n_heads) for t in (q, k, v))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * (1.0 / dh ** 0.5)
    kpos = torch.arange(lk, device=q.device)
    see = (kv_valid.bool() & (kpos[None, :] < kv_len[:, None]))[:, None, None, :]  # [B, 1, 1, Lk]
    if causal:
        qpos = torch.arange(lq, device=q.device)[:, None]
        band = kpos[None, :] <= qpos
        window = band_window(causal, window)
        if window > 0:
            band &= kpos[None, :] >= qpos - window
        see = see & band
    s = torch.where(see, s, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)  # not exp(s - lse): -1e30 + log(Lk) rounds to -1e30 in a row with no valid key
    if dropout_rate > 0.0:
        keep = keep_mask(int(seed), b, n_heads, lq, lk, dropout_rate, q.device, block_q, block_k)
        p = torch.where(keep, p / _keep_den(dropout_rate), 0.0)
    p = p.to(v.dtype).float()
    o = torch.matmul(p, vh).transpose(1, 2).reshape(b, lq, pd)
    return o.to(q.dtype), lse


# ------------------------------------------------------------------ kernels


def _check_cuda_inputs(q, k, v, kv_len, kv_valid, seed, n_heads, mask_bq, mask_bk):
    if mask_bq % KERNEL_TILE or mask_bk % KERNEL_TILE:
        raise ValueError("the mask geometry must be a multiple of the kernel tile")
    b, lq, pd = q.shape
    if pd != n_heads * HEAD_DIM:
        raise ValueError(f"the CUDA flash kernels take heads of {HEAD_DIM}, got width {pd} for {n_heads} heads")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.dtype != torch.bfloat16 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned bfloat16 CUDA tensor, "
                             f"got {t.dtype} on {t.device}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != pd:
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do not match q {tuple(q.shape)}")
    lk = k.shape[1]
    if kv_len.dtype != torch.int32 or kv_len.shape != (b,) or kv_len.device != q.device:
        raise ValueError("kv_len must be int32 [B] on q's device")
    if kv_valid.dtype != torch.bool or kv_valid.shape != (b, lk) or not kv_valid.is_contiguous() \
            or kv_valid.device != q.device:
        raise ValueError("kv_valid must be a contiguous bool [B, Lk] tensor on q's device")
    if seed.dtype != torch.int32 or seed.numel() != 1 or seed.device != q.device:
        raise ValueError("seed must be a one-element int32 tensor on q's device")


def _check_bwd_inputs(q, do, lse, delta, n_heads):
    b, lq, _ = q.shape
    if do.shape != q.shape or do.dtype != torch.bfloat16 or not do.is_contiguous():
        raise ValueError(f"do must be a contiguous bfloat16 tensor of q's shape {tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or t.shape != (b, n_heads, lq) or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be a contiguous float32 [B, H, Lq] tensor on q's device")


def _dropout_args(rate: float):
    return float(rate), _keep_scale(rate), dropout_threshold(rate)


FWD_ROWS = 192  # queries per K1 block (three consumer warpgroups of 64)
FWD_BLOCKS_PER_SM = 1  # K1's registers and shared memory hold one block on an SM
# a K1 block's set-up, epilogue and share of the merge, in 64-key tile times: K1's times at 1-8 chunks
# (chip_smoke.py, flagship cross shape, H100 SXM) fit 1.5-2.9 and are fastest at this model's choice
FWD_BLOCK_OVERHEAD_TILES = 2
MAX_FWD_SPLITS = 16
# consumer warpgroups of 64 queries in a non-causal K3a block (one block an SM), fixed in csrc/flash_dq.cu:
# three were 6-8% faster than two at the flagship cross shape and dropout 0.1 on the H100 (a causal block
# holds two, 7-15% faster than three at the paper's self-attention shape)
DQ_CONSUMERS = 3


def _key_splits(units: int, n_tiles: int, slots: int, overhead: int, max_splits: int) -> Tuple[int, int]:
    """(n_split, per) minimizing waves x block time, ceil(units * n_split /
    slots) x (per + overhead), over splits of n_tiles key tiles into chunks
    of ``per`` that each hold a tile; ties go to the fewer chunks."""
    best = None
    for n_split in range(1, min(max_splits, n_tiles) + 1):
        per = -(-n_tiles // n_split)
        if -(-n_tiles // per) != n_split:
            continue
        cost = -(-units * n_split // max(1, slots)) * (per + overhead)
        if best is None or cost < best[0]:
            best = (cost, n_split, per)
    return best[1], best[2]


def fwd_splits(batch: int, n_heads: int, lq: int, lk: int, n_sm: int, rows: int = FWD_ROWS) -> Tuple[int, int]:
    """(n_split, per): K1 (and L1/L2a, whose block is K1's, with blocks of
    their own ``rows`` queries) walks its ceil(lk / 64) key tiles in n_split
    chunks of ``per`` tiles, each chunk a block of its own, merged by lse.
    The split minimizes waves x block time over the card's n_sm one-block
    slots (``_key_splits``). At the flagship cross shape (224 blocks of
    192 queries, 199 key tiles) on 132 SMs it picks 4: 896 blocks in 6.79
    waves (7) instead of 224 in 1.70 (2)."""
    units = -(-lq // rows) * n_heads * batch
    return _key_splits(units, -(-lk // KERNEL_TILE), n_sm * FWD_BLOCKS_PER_SM, FWD_BLOCK_OVERHEAD_TILES,
                       MAX_FWD_SPLITS)


def dq_splits(batch: int, n_heads: int, lq: int, lk: int, n_sm: int,
              consumers: int = DQ_CONSUMERS) -> Tuple[int, int]:
    """(n_split, per): K3a (and L2b, whose block is K3a's, with its own
    ``consumers``) walks its ceil(lk / 64) key tiles in n_split chunks of
    ``per`` tiles, each chunk a block of its own writing an f32 dq partial,
    summed in chunk order by the merge kernel. The chooser is K1's
    (``fwd_splits``, with K1's fitted set-up constant) for blocks of
    ``consumers`` x 64 queries, one an SM; it is not fitted to K3a, whose
    blocks differ in length because key tiles with no valid key are
    skipped. At the flagship cross shape (224 blocks of 192 queries, 199
    key tiles) on 132 SMs it picks 4, 896 blocks in 6.79 waves (7) instead
    of 224 in 1.70 (2); there 3 chunks ran faster than 4 in every 1-8
    chunk sweep of chip_smoke.py on the H100 (by 0-5%), so it is off by
    one chunk."""
    units = -(-lq // (64 * consumers)) * n_heads * batch
    return _key_splits(units, -(-lk // KERNEL_TILE), n_sm, FWD_BLOCK_OVERHEAD_TILES, MAX_FWD_SPLITS)


def _split_of(n_tiles: int, n_split: int) -> Tuple[int, int]:
    """(n_split, per) for a given chunk count: ``per`` tiles a chunk, every
    chunk holding at least one tile."""
    per = -(-n_tiles // max(n_split, 1))
    if not 1 <= n_split <= n_tiles or -(-n_tiles // per) != n_split:
        raise ValueError(f"{n_tiles} key tiles do not split into {n_split} chunks")
    return n_split, per


_SM_COUNT = {}


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SM_COUNT[idx]


def _launch_fwd(q, k, v, kv_len, kv_valid, seed, dropout_rate, n_heads, mask_bq, mask_bk, causal, window,
                n_split=None):
    _check_cuda_inputs(q, k, v, kv_len, kv_valid, seed, n_heads, mask_bq, mask_bk)
    b, lq, pd = q.shape
    lk = k.shape[1]
    o = torch.empty_like(q)
    lse = torch.empty((b, n_heads, lq), device=q.device, dtype=torch.float32)
    if causal:
        n_split, per = 1, 1
    elif n_split is None:
        n_split, per = fwd_splits(b, n_heads, lq, lk, _sm_count(q.device))
    else:
        n_split, per = _split_of(-(-lk // KERNEL_TILE), n_split)
    o_part = lse_part = None
    if n_split > 1:  # scratch of K1's key chunks
        o_part = torch.empty((n_split, b, lq, pd), device=q.device, dtype=torch.float32)
        lse_part = torch.empty((n_split, b, n_heads, lq), device=q.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = cuda_build.launch(
        "flash_fwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(), kv_valid.data_ptr(),
        seed.data_ptr(), o.data_ptr(), lse.data_ptr(), None if o_part is None else o_part.data_ptr(),
        None if lse_part is None else lse_part.data_ptr(), b, n_heads, lq, lk, mask_bq, mask_bk,
        int(causal), band_window(causal, window), n_split, per, *_dropout_args(dropout_rate), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError {err}")
    return o, lse


def flash_fwd_cuda(q, k, v, kv_len, kv_valid, seed, dropout_rate, n_heads, mask_bq, mask_bk, n_split=None):
    """Launch K1 (non-causal): its key chunks and, for more than one, the
    merge kernel. ``n_split`` chunks when given (chip_smoke.py times each
    split), else ``fwd_splits``'s choice for the card. Returns (o bf16
    [B, Lq, H*64], lse f32 [B, H, Lq])."""
    out = _launch_fwd(q, k, v, kv_len, kv_valid, seed, dropout_rate, n_heads, mask_bq, mask_bk, False, -1,
                      n_split)
    flash_fwd_cuda.launches += 1
    return out


flash_fwd_cuda.launches = 0


def flash_fwd_causal_cuda(q, k, v, kv_len, kv_valid, seed, dropout_rate, n_heads, mask_bq, mask_bk, window=-1):
    """Launch K1c (causal; keys k >= q - window too when window > 0), one
    block of ``causal_fwd_plan`` a k1c::CONSUMERS x 64-query tile
    (csrc/k1c_plan.h).
    Returns (o, lse) as K1. A query whose band holds no key it may see (a
    pad query more than ``window`` past the last valid key) gets the mean
    of v, dropout applied, over the 64-key tiles of its band, with lse
    about -6.9e29, or o = 0 and lse = 0 where its band holds no key tile
    (the arithmetic of K1's block)."""
    out = _launch_fwd(q, k, v, kv_len, kv_valid, seed, dropout_rate, n_heads, mask_bq, mask_bk, True, window)
    flash_fwd_causal_cuda.launches += 1
    return out


flash_fwd_causal_cuda.launches = 0


def causal_fwd_plan(batch: int, n_heads: int, lq: int) -> dict:
    """K1c's launch for ``batch`` rows of ``lq`` queries and ``n_heads``
    heads, as csrc/flash_fwd.cu launches it (flash_fwd_causal_plan):
    threads, grid, dynamic shared memory bytes and consumer warpgroups of
    64 queries a block."""
    out = (ctypes.c_int * 6)()
    cuda_build.library("flash_fwd").flash_fwd_causal_plan(batch, n_heads, lq, out)
    threads, gx, gy, gz, smem, consumers = out
    return dict(threads=threads, grid=[gx, gy, gz], smem_bytes=smem, consumers=consumers)


def attention_delta(do: torch.Tensor, o: torch.Tensor, n_heads: int) -> torch.Tensor:
    """delta = rowsum(do * o) per (b, h, q), f32 [B, H, Lq]: a PyTorch
    expression, as it is XLA outside the TPU kernels."""
    b, lq, pd = o.shape
    return (do.float() * o.float()).reshape(b, lq, n_heads, pd // n_heads).sum(-1).transpose(1, 2).contiguous()


def bwd_stats(lse: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """(lse * log2 e, delta) per query as f32 pairs, [B, H, Lq_p, 2] with
    Lq padded to the 64-query tile and zero past Lq: what K2, K3a and K3b
    read (K2 and K3b a tile's pairs in one bulk copy)."""
    lq = lse.shape[-1]
    return torch.nn.functional.pad(torch.stack((lse * LOG2E, delta), -1), (0, 0, 0, _round_up(lq, KERNEL_TILE) - lq))


def flash_bwd_cuda(q, k, v, kv_len, kv_valid, seed, o, lse, do, dropout_rate, n_heads, mask_bq, mask_bk):
    """Launch K2 (merged backward of a non-causal call). Returns (dq, dk, dv)
    bf16; dq is summed in float32 across key blocks by bulk reduce-adds
    (not bitwise deterministic), dk and dv are written once."""
    _check_cuda_inputs(q, k, v, kv_len, kv_valid, seed, n_heads, mask_bq, mask_bk)
    b, lq, pd = q.shape
    lk = k.shape[1]
    if o.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} must have q's shape {tuple(q.shape)}")
    do = do.to(torch.bfloat16).contiguous()
    delta = attention_delta(do, o, n_heads)
    _check_bwd_inputs(q, do, lse, delta, n_heads)
    stats = bwd_stats(lse, delta)
    dq_acc = torch.zeros((b, lq, pd), device=q.device, dtype=torch.float32)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = cuda_build.launch(
        "flash_bwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(), kv_valid.data_ptr(),
        seed.data_ptr(), do.data_ptr(), stats.data_ptr(), dq_acc.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, n_heads, lq, lk, mask_bq, mask_bk,
        *_dropout_args(dropout_rate), stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd launch failed: cudaError {err}")
    flash_bwd_cuda.launches += 1
    return dq_acc.to(q.dtype), dk, dv


flash_bwd_cuda.launches = 0


def flash_dq_cuda(q, k, v, kv_len, kv_valid, seed, do, lse, delta, dropout_rate, n_heads, mask_bq, mask_bk,
                  causal=False, window=-1, n_split=None):
    """Launch K3a: dq (bf16) of the split backward, given the forward's lse
    and ``attention_delta``. A non-causal call walks the keys in ``n_split``
    chunks when given (chip_smoke.py times each split), else in
    ``dq_splits``'s for the card, and for more than one also launches the
    merge kernel; a causal call walks its band in one. Deterministic: the
    chunks' f32 partials are summed in a fixed order."""
    _check_cuda_inputs(q, k, v, kv_len, kv_valid, seed, n_heads, mask_bq, mask_bk)
    _check_bwd_inputs(q, do, lse, delta, n_heads)
    b, lq, pd = q.shape
    lk = k.shape[1]
    if causal:
        n_split, per = 1, 1
    elif n_split is None:
        n_split, per = dq_splits(b, n_heads, lq, lk, _sm_count(q.device))
    else:
        n_split, per = _split_of(-(-lk // KERNEL_TILE), n_split)
    stats = bwd_stats(lse, delta)
    dq = torch.empty_like(q)
    dq_part = torch.empty((n_split, b, lq, pd), device=q.device, dtype=torch.float32) if n_split > 1 else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = cuda_build.launch(
        "flash_dq", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(), kv_valid.data_ptr(),
        seed.data_ptr(), do.data_ptr(), stats.data_ptr(), dq.data_ptr(),
        None if dq_part is None else dq_part.data_ptr(), b, n_heads, lq, lk, mask_bq, mask_bk, int(causal),
        band_window(causal, window), n_split, per, *_dropout_args(dropout_rate), stream)
    if err != 0:
        raise RuntimeError(f"flash_dq launch failed: cudaError {err}")
    flash_dq_cuda.launches += 1
    return dq


flash_dq_cuda.launches = 0


def flash_dkv_cuda(q, k, v, kv_len, kv_valid, seed, do, lse, delta, dropout_rate, n_heads, mask_bq, mask_bk,
                   causal=False, window=-1):
    """Launch K3b: (dk, dv) bf16 of the split backward, given the forward's
    lse and ``attention_delta``. Deterministic: each row is written once."""
    _check_cuda_inputs(q, k, v, kv_len, kv_valid, seed, n_heads, mask_bq, mask_bk)
    _check_bwd_inputs(q, do, lse, delta, n_heads)
    b, lq, _ = q.shape
    stats = bwd_stats(lse, delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = cuda_build.launch(
        "flash_dkv", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(), kv_valid.data_ptr(),
        seed.data_ptr(), do.data_ptr(), stats.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, n_heads, lq, k.shape[1], mask_bq, mask_bk, int(causal), band_window(causal, window),
        *_dropout_args(dropout_rate), stream)
    if err != 0:
        raise RuntimeError(f"flash_dkv launch failed: cudaError {err}")
    flash_dkv_cuda.launches += 1
    return dk, dv


flash_dkv_cuda.launches = 0


def keep_mask_cuda(seed: torch.Tensor, batch: int, n_heads: int, lq_p: int, lk_p: int, rate: float,
                   mask_bq: int, mask_bk: int) -> torch.Tensor:
    """Launch K4: the [B, H, lq_p, lk_p] bool keep-mask at the mask geometry
    (mask_bq, mask_bk), for the padded lengths of that geometry. A
    persistent grid of 4 blocks an SM (the walk of csrc/keep_mask_plan.h),
    so any size launches."""
    if mask_bk % KEEP_MASK_KEYS or lk_p % KEEP_MASK_KEYS:
        raise ValueError(f"K4 writes {KEEP_MASK_KEYS} keys a lane: the k block and Lk_p must be multiples of it")
    if mask_bq < 1 or lq_p % mask_bq:
        raise ValueError(f"Lq_p {lq_p} must be a multiple of the q block {mask_bq}")
    if seed.device.type != "cuda" or seed.dtype != torch.int32 or seed.numel() != 1:
        raise ValueError("seed must be a one-element int32 CUDA tensor")
    out = torch.empty((batch, n_heads, lq_p, lk_p), device=seed.device, dtype=torch.bool)
    stream = torch.cuda.current_stream(seed.device).cuda_stream
    err = cuda_build.launch("keep_mask", seed.device, seed.data_ptr(), out.data_ptr(), batch, n_heads, lq_p, lk_p,
                            mask_bq, mask_bk, dropout_threshold(rate), stream)
    if err != 0:
        raise RuntimeError(f"keep_mask launch failed: cudaError {err}")
    keep_mask_cuda.launches += 1
    return out


keep_mask_cuda.launches = 0


# ------------------------------------------------------------------ autograd


class FlashAttention(torch.autograd.Function):
    """K1 or K1c forward; K2, or K3a then K3b, backward (the JAX
    ``_bwd_rule`` choice, ops/flash_packed.py:581: merged only for a merged,
    non-causal call). Saves q, k, v, o and lse (no score tensor)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, kv_valid, seed, dropout_rate, n_heads, mask_bq, mask_bk,
                causal, window, merged_bwd):
        if causal:
            o, lse = flash_fwd_causal_cuda(q, k, v, kv_len, kv_valid, seed, dropout_rate, n_heads,
                                           mask_bq, mask_bk, window)
        else:
            o, lse = flash_fwd_cuda(q, k, v, kv_len, kv_valid, seed, dropout_rate, n_heads, mask_bq, mask_bk)
        ctx.save_for_backward(q, k, v, kv_len, kv_valid, seed, o, lse)
        ctx.cfg = (dropout_rate, n_heads, mask_bq, mask_bk)
        ctx.band = (causal, window, merged_bwd)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, kv_len, kv_valid, seed, o, lse = ctx.saved_tensors
        causal, window, merged_bwd = ctx.band
        if merged_bwd and not causal:
            dq, dk, dv = flash_bwd_cuda(q, k, v, kv_len, kv_valid, seed, o, lse, do, *ctx.cfg)
        else:
            do = do.to(torch.bfloat16).contiguous()
            delta = attention_delta(do, o, ctx.cfg[1])
            args = (q, k, v, kv_len, kv_valid, seed, do, lse, delta, *ctx.cfg, causal, window)
            dq = flash_dq_cuda(*args)
            dk, dv = flash_dkv_cuda(*args)
        return dq, dk, dv, None, None, None, None, None, None, None, None, None, None


def _seed_tensor(seed, device) -> torch.Tensor:
    if isinstance(seed, torch.Tensor):
        return seed.reshape(1).to(device=device, dtype=torch.int32)
    return torch.tensor([int(seed)], dtype=torch.int32, device=device)


def make_flash_attention_packed(n_heads: int, causal: bool = False, window: int = -1, block_q: int = 128,
                                block_k: int = 512, dropout_rate: float = 0.0, merged_bwd: bool = True):
    """Differentiable packed flash attention with the JAX factory's
    signature and defaults (ops/flash_packed.py:458-467).

    Returns f(q, k, v, kv_len, kv_valid, seed) -> o with q [B, Lq, H*Dh],
    k/v [B, Lk, H*Dh], kv_len [B] int32, kv_valid [B, Lk] bool and seed an
    int or a one-element int32 tensor (dropout stream id; unused at rate
    0). The keep-mask follows the mask geometry of (block_q, block_k). CPU
    tensors take the plain version; CUDA tensors launch K1 or K1c, and in
    the backward K2 for a merged non-causal call, else K3a and K3b.
    """
    window = band_window(causal, window)

    def flash(q, k, v, kv_len, kv_valid, seed):
        bq, bk = mask_geometry(q.shape[1], k.shape[1], block_q, block_k)
        if q.device.type == "cpu":
            o, _ = flash_attention_plain(q, k, v, kv_len, kv_valid, seed, dropout_rate, n_heads,
                                         causal, window, bq, bk)
            return o
        if q.device.type != "cuda":
            raise ValueError(f"flash attention runs on CPU or CUDA tensors, got {q.device}")
        o, _ = FlashAttention.apply(q, k, v, kv_len, kv_valid, _seed_tensor(seed, q.device), dropout_rate,
                                    n_heads, bq, bk, causal, window, merged_bwd)
        return o

    return flash


def flash_attention_packed(q, k, v, kv_len, kv_valid, seed, dropout_rate: float = 0.0, n_heads: int = 4):
    """The decoder's cross-attention call: non-causal with the merged
    backward (K1/K2 on CUDA), at the decoder's mask geometry (128/2048).
    Returns o [B, Lq, H*Dh]; arguments as for ``make_flash_attention_packed``.
    """
    flash = make_flash_attention_packed(n_heads, block_q=MASK_BQ, block_k=MASK_BK, dropout_rate=dropout_rate)
    return flash(q, k, v, kv_len, kv_valid, seed)


# the JAX dispatch's per-shard seed mixing constants (flash_packed.py:865-872)
SEED_DATA_MIX, SEED_MODEL_MIX = 479001599, 15485863


def _int32(x: int) -> int:
    """x wrapped to a signed 32-bit integer (JAX's int32 product)."""
    return (x + 2 ** 31) % 2 ** 32 - 2 ** 31


def shard_heads(n_heads: int, dh: int, model: int) -> bool:
    """Whether the sharded dispatch splits the heads over 'model': whole
    128-lane head groups per shard, as JAX requires (``:850-854``). With 4
    heads of 64 only a model axis of 2 does."""
    group = max(1, 128 // dh)
    return model > 1 and n_heads % model == 0 and (n_heads // model) % group == 0


def shard_seed(data_index: int, model_index: int, heads_split: bool) -> int:
    """What a shard XORs into the dropout seed: the data index times
    479001599, XOR the model index times 15485863 when the heads are split,
    each wrapped to int32 as in JAX, so the shard's hash masks are those of
    JAX's shard at the same place bit for bit."""
    mix = _int32(data_index * SEED_DATA_MIX)
    if heads_split:
        mix ^= _int32(model_index * SEED_MODEL_MIX)
    return mix


def flash_attention_packed_auto(n_heads: int, dh: int, batch: int, *, block_q: int = 128, block_k: int = 512,
                                dropout_rate: float = 0.0, mesh=None):
    """Packed flash attention on this rank's shard of a mesh: the
    counterpart of JAX's ``flash_attention_packed_auto``
    (ops/flash_packed.py:822-879), for the batch of ``batch`` global rows
    and ``n_heads`` global heads of ``dh`` columns.

    Returns f(q, k, v, kv_len, kv_valid, seed) -> o on this rank's rows
    and heads: the rows of its data index and, under a 'model' axis, the
    heads its column-parallel projections give it. The kernel (K1/K2 on the
    card) runs on the rank's rows; the heads stay split when
    ``shard_heads``, else q/k/v are gathered back to all heads before the
    kernel and o is cut back to the rank's heads after it. The seed is
    mixed with the shard's place (``shard_seed``). Without a mesh, or on a
    mesh of one process, it is ``make_flash_attention_packed``. Non-causal
    (JAX's ``causal``/``window`` arguments have no caller).
    """
    if mesh is None or mesh.size == 1:
        return make_flash_attention_packed(n_heads, block_q=block_q, block_k=block_k, dropout_rate=dropout_rate)
    from omr_a2s_multimodal_transformer_tpu_torch.parallel.collectives import gather_from, scatter_to

    if batch % mesh.data:
        raise ValueError(f"a batch of {batch} rows does not split over {mesh.data} data ranks (shard_batch pads it)")
    split = shard_heads(n_heads, dh, mesh.model)
    gather = mesh.model > 1 and not split
    inner = make_flash_attention_packed(n_heads // mesh.model if split else n_heads, block_q=block_q,
                                        block_k=block_k, dropout_rate=dropout_rate)
    mix = shard_seed(mesh.data_index, mesh.model_index, split)
    axis = mesh.model_axis

    def flash(q, k, v, kv_len, kv_valid, seed):
        seed = _seed_tensor(seed, q.device) ^ mix
        if gather:
            q, k, v = (gather_from(t, axis, -1).contiguous() for t in (q, k, v))
        o = inner(q, k, v, kv_len, kv_valid, seed)
        return scatter_to(o, axis, -1) if gather else o

    return flash


def export_keep_masks(seed: int, batch: int, n_heads: int, lq: int, lk: int, *, dropout_rate: float,
                      block_q: int = 128, block_k: int = 512, device: DeviceLike = None) -> torch.Tensor:
    """The dropout keep-masks that the flash kernels regenerate, as the
    JAX probe returns them (ops/flash_packed.py:727-765): [B, H, Lq_p,
    Lk_p] bool over the lengths padded to the mask geometry of (block_q,
    block_k). Runs on ``device`` (``cuda`` unless the caller says
    otherwise): CUDA launches K4, the CPU takes ``keep_mask``."""
    dev = resolve_device(device)
    bq, bk = mask_geometry(lq, lk, block_q, block_k)
    lq_p, lk_p = _round_up(lq, bq), _round_up(lk, bk)
    if dev.type == "cpu":
        return keep_mask(int(seed), batch, n_heads, lq_p, lk_p, dropout_rate, dev, bq, bk)
    if dev.type != "cuda":
        raise ValueError(f"export_keep_masks runs on the CPU or CUDA, got {dev}")
    return keep_mask_cuda(_seed_tensor(seed, dev), batch, n_heads, lq_p, lk_p, dropout_rate, bq, bk)
