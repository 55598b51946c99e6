"""Per-head flash attention, forward only: the legacy kernel L1.

Port of ``tools/legacy_flash/flash_attention.py``. For q [B, H, Lq, D] and
k, v [B, H, Lk, D],

    o = softmax(q k^T / sqrt(D) + mask) v

where query q sees key k when k < kv_len[b] and, for a causal call, k <= q
and (window > 0 only) k >= q - window. The round-1 per-head layout is kept
as the baseline that ``tools/bench_flash_packed.py`` holds the head-packed
kernels against; no model calls it.

Two routes, chosen by where the tensors lie, never by a switch:

- CUDA tensors launch L1 (``csrc/legacy_flash_fwd.cu``: K1's TMA/wgmma
  block of ``csrc/flash_fwd.cuh`` per head) for bfloat16 heads of width
  D <= 128 (the block is built for 64 and 128 columns, and its tensor maps
  read the columns past D as zero; a D that is not a multiple of 8 is
  zero-padded here). A non-causal call walks its key tiles in
  ``legacy_fwd_splits`` chunks whose f32 partials a second kernel merges
  by lse in chunk order; a causal call walks its band in one. What L1 does
  not take goes to the any-dtype forward
  (``csrc/legacy_flash_any_fwd.cu``) for float16, float32, wider heads and
  misaligned rows, as the JAX kernels take any float dtype and width. That
  forward runs on the tensor cores too, in 64-column chunks (float16 on
  m16n8k16, float32 as three TF32 passes); its 16-byte copies need rows of
  a multiple of 16 bytes at 16-byte-aligned addresses, which
  ``any_operands`` makes. The wrappers raise ``ValueError`` for another
  dtype, non-contiguous tensors or mixed devices; ``flash_attention`` makes
  its inputs contiguous.
- CPU tensors take ``flash_attention_plain``, dense masked softmax in
  float32.

A query row with no key to see gets o = 0 (and lse = 0 where it is
returned) in both routes, whatever key tiles ran. The JAX kernel's comment
intends the same, but it returns the mean of v over the blocks it visited
when such a block held no key for the row; its gradients do not depend on
this (ROADMAP Queue 3).

Also here, for the forward of L2 (``flash_attention_bwd.py``): the key
mask, the dense plain version with lse, the input checks, the operands of
the any-dtype kernels and the launches.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from omr_a2s_multimodal_transformer_tpu_torch.ops import cuda_build
from omr_a2s_multimodal_transformer_tpu_torch.ops.flash_packed import (
    KERNEL_TILE, _sm_count, _split_of, band_window, fwd_splits)

NEG_INF = -1e30
MAX_HEAD_DIM = 128  # the widest head the bf16 tensor-core kernels are built for
# consumer warpgroups of 64 queries in an L1/L2a block by head width class: K1's three at 64 columns, two at
# 128 (three, at 160 registers a thread, were slower on the H100). lf_fwd_launch (csrc/legacy_flash_fwd.cu)
# picks the same counts by D and must match this table, which sizes the key chunks for its blocks.
LEGACY_FWD_CONSUMERS = {64: 3, 128: 2}


def visible_keys(lq: int, lk: int, kv_len: torch.Tensor, kv_valid: Optional[torch.Tensor], causal: bool,
                 window: int) -> torch.Tensor:
    """[B, 1, Lq or 1, Lk] bool: query q sees key k. JAX ``_mask``
    (flash_attention_bwd.py:43-51): k < kv_len, then k <= q, then
    k >= q - window; L2 adds ``kv_valid[b, k]``."""
    kpos = torch.arange(lk, device=kv_len.device)
    see = kpos[None, :] < kv_len[:, None].long()
    if kv_valid is not None:
        see = see & kv_valid.bool()
    see = see[:, None, None, :]
    if causal:
        qpos = torch.arange(lq, device=kv_len.device)[:, None]
        band = kpos[None, :] <= qpos
        if window > 0:
            band &= kpos[None, :] >= qpos - window
        see = see & band
    return see


def attention_plain(q, k, v, kv_len, kv_valid=None, causal: bool = False, window: int = -1):
    """Plain PyTorch version of L1 and L2a (autograd gives the function of
    L2b and L2c). Returns (o in q's dtype, lse f32 [B, H, Lq]).

    Scores, softmax and p v are float32, as in the JAX kernels; the scale
    is 1/sqrt(D). Rows with no key to see get o = 0 and lse = 0 (and no
    gradient)."""
    window = band_window(causal, window)
    see = visible_keys(q.shape[2], k.shape[2], kv_len, kv_valid, causal, window)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / q.shape[-1] ** 0.5)
    s = torch.where(see, s, NEG_INF)
    seen = see.any(-1)  # [B, 1, Lq or 1]
    p = torch.where(seen[..., None], torch.softmax(s, dim=-1), 0.0)
    o = torch.matmul(p, v.float())
    lse = torch.where(seen, torch.logsumexp(s, dim=-1), 0.0)
    return o.to(q.dtype), lse


def kv_len_tensor(kv_len, q: torch.Tensor, lk: int) -> torch.Tensor:
    """kv_len as int32 [B] (all Lk when None), as the JAX wrappers cast it."""
    if kv_len is None:
        return torch.full((q.shape[0],), lk, dtype=torch.int32, device=q.device)
    return kv_len.to(torch.int32)


def flash_attention_plain(q, k, v, kv_len=None, causal: bool = False, window: int = -1):
    """Plain version of L1: o [B, H, Lq, D] in q's dtype."""
    return attention_plain(q, k, v, kv_len_tensor(kv_len, q, k.shape[2]), None, causal, window)[0]


# ------------------------------------------------------------------ kernels


KERNEL_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}  # the dtype codes of the any-dtype kernels


def _check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, q on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} for the CUDA kernels, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_inputs(q, k, v, kv_len, kv_valid=None) -> None:
    """What L1, L2a, L2b and L2c take: [B, H, L, D] CUDA tensors of one
    float type (bfloat16, float16 or float32), any D, int32 kv_len [B], bool
    kv_valid [B, Lk], all contiguous on q's device."""
    if q.device.type != "cuda":
        raise ValueError(f"the legacy flash kernels run on CUDA tensors, got {q.device}")
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"the legacy flash kernels take bfloat16, float16 or float32, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_cuda(name, t, q.dtype, q.device)
    if q.dim() != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} are not [B, H, L, D] alike")
    _check_cuda("kv_len", kv_len, torch.int32, q.device)
    if kv_len.shape != (q.shape[0],):
        raise ValueError(f"kv_len must be [B], got {tuple(kv_len.shape)}")
    if kv_valid is not None:
        _check_cuda("kv_valid", kv_valid, torch.bool, q.device)
        if kv_valid.shape != (q.shape[0], k.shape[2]):
            raise ValueError(f"kv_valid must be [B, Lk], got {tuple(kv_valid.shape)}")


def check_backward_inputs(q, do, lse, delta) -> None:
    _check_cuda("do", do, q.dtype, q.device)
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} must have q's shape {tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        _check_cuda(name, t, torch.float32, q.device)
        if t.shape != q.shape[:3]:
            raise ValueError(f"{name} must be [B, H, Lq], got {tuple(t.shape)}")


def tensor_core_route(*tensors: torch.Tensor) -> bool:
    """Whether the bf16 tensor-core kernels take these [B, H, L, D]
    tensors (bf16, D <= 128, 16-byte aligned rows once the width is padded
    to a multiple of 8); everything else goes to the any-dtype kernels."""
    d = tensors[0].shape[-1]
    return (tensors[0].dtype == torch.bfloat16 and d <= MAX_HEAD_DIM
            and (d % 8 != 0 or all(t.data_ptr() % 16 == 0 for t in tensors)))


def width_class(d: int) -> int:
    """The head width L1, L2a, L2b and L2c are built for that holds a head of
    d <= 128 columns: 64 or 128 (the columns past d read as zero)."""
    return 64 if d <= 64 else 128


def legacy_fwd_splits(batch: int, n_heads: int, lq: int, lk: int, d: int, n_sm: int, causal: bool = False):
    """(n_split, per): the key chunks of an L1 or L2a call. A causal call
    walks its band in one chunk; a non-causal one takes K1's chooser
    (``fwd_splits``) over its blocks of ``LEGACY_FWD_CONSUMERS`` x 64
    queries per (b, h) for d's width class. At the legacy cross shape
    (B 8, H 4, Lq 1268, Lk 12,696, D 64) those are K1's 224 blocks and its
    4 chunks of 50 key tiles; at D 128 with 2 heads, 160 blocks and 4
    chunks. The chooser counts every key tile, as the kernel's chunks do; a
    block walks only those below kv_len."""
    if causal:
        return 1, -(-lk // KERNEL_TILE)
    return fwd_splits(batch, n_heads, lq, lk, n_sm, rows=64 * LEGACY_FWD_CONSUMERS[width_class(d)])


def pad_head_dim(t: torch.Tensor) -> torch.Tensor:
    """Zero-pad the head width to a multiple of 8 (16-byte rows for the
    kernels' copies); padded columns add 0 to q k^T and give zero columns."""
    d = t.shape[-1]
    return t if d % 8 == 0 else F.pad(t, (0, 8 - d % 8)).contiguous()


def unpad_head_dim(t: torch.Tensor, d: int) -> torch.Tensor:
    return t if t.shape[-1] == d else t[..., :d].contiguous()


def launch_fwd(q, k, v, kv_len, kv_valid, causal: bool, window: int, with_lse: bool, n_split=None):
    """Run L1 (with_lse False, no kv_valid) or L2a on checked inputs that
    ``tensor_core_route`` takes: a non-causal call in ``n_split`` key chunks
    when given, else in ``legacy_fwd_splits``'s for the card, and for more
    than one the merge kernel too; a causal call in one (``n_split`` 1 or
    None). Returns (o bf16 [B, H, Lq, D], lse f32 [B, H, Lq] or None)."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    qp, kp, vp = (pad_head_dim(t) for t in (q, k, v))
    if n_split is None:
        n_split, per = legacy_fwd_splits(b, h, lq, lk, qp.shape[3], _sm_count(q.device), causal)
    elif causal and n_split != 1:
        raise ValueError("a causal call walks its band in one key chunk")
    else:
        n_split, per = _split_of(-(-lk // KERNEL_TILE), n_split)
    o = torch.empty_like(qp)
    lse = torch.empty((b, h, lq), device=q.device, dtype=torch.float32) if with_lse else None
    o_part = lse_part = None
    if n_split > 1:  # scratch of the key chunks (L1's lse too)
        o_part = torch.empty((n_split, *qp.shape), device=q.device, dtype=torch.float32)
        lse_part = torch.empty((n_split, b, h, lq), device=q.device, dtype=torch.float32)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = cuda_build.launch("legacy_flash_fwd", q.device, qp.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                            kv_len.data_ptr(), ptr(kv_valid), o.data_ptr(), ptr(lse), ptr(o_part), ptr(lse_part), b, h,
                            lq, lk, qp.shape[3], int(causal), band_window(causal, window), int(with_lse), n_split, per,
                            1.0 / d ** 0.5, stream)
    if err != 0:
        raise RuntimeError(f"legacy_flash_fwd launch failed: cudaError {err}")
    return unpad_head_dim(o, d), lse


def any_operands(*tensors: torch.Tensor) -> list:
    """The operands of the any-dtype kernels, whose cp.async copies move 16
    bytes: when the rows of the first are not a multiple of 16 bytes, all
    are zero-padded to a multiple of 8 columns in fresh tensors (padded
    columns add 0 to every product; the wrappers cut them from the
    outputs); otherwise an operand whose address is not 16-byte aligned is
    copied."""
    if tensors[0].shape[-1] * tensors[0].element_size() % 16:
        return [pad_head_dim(t) for t in tensors]
    return [t if t.data_ptr() % 16 == 0 else t.clone() for t in tensors]


def legacy_any_fwd_cuda(q, k, v, kv_len, kv_valid, causal: bool, window: int, with_lse: bool):
    """Launch the any-dtype forward (``csrc/legacy_flash_any_fwd.cu``,
    tensor cores): L1 (with_lse False; kv_valid ignored) or L2a for
    float16, float32, heads wider than 128 or misaligned bf16 rows, on
    checked inputs. Returns (o in q's dtype, lse f32 [B, H, Lq] or None)."""
    b, h, lq, d = q.shape
    qp, kp, vp = any_operands(q, k, v)
    o = torch.empty_like(qp)
    lse = torch.empty((b, h, lq), device=q.device, dtype=torch.float32) if with_lse else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = cuda_build.launch("legacy_flash_any_fwd", q.device, qp.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                            kv_len.data_ptr(), kv_valid.data_ptr() if with_lse else None, o.data_ptr(),
                            None if lse is None else lse.data_ptr(), KERNEL_DTYPES[q.dtype], b, h, lq, k.shape[2],
                            qp.shape[3], int(causal), band_window(causal, window), int(with_lse), 1.0 / d ** 0.5,
                            stream)
    if err != 0:
        raise RuntimeError(f"legacy_flash_any_fwd launch failed: cudaError {err}")
    legacy_any_fwd_cuda.launches += 1
    return unpad_head_dim(o, d), lse


legacy_any_fwd_cuda.launches = 0


def legacy_fwd_cuda(q, k, v, kv_len, causal: bool = False, window: int = -1, n_split=None) -> torch.Tensor:
    """Launch L1 (bf16, D <= 128; its key chunks and merge, ``launch_fwd``)
    or, for what it does not take, the any-dtype forward. Returns o
    ([B, H, Lq, D] in q's dtype). Deterministic: the chunks are merged in a
    fixed order."""
    check_inputs(q, k, v, kv_len)
    if not tensor_core_route(q, k, v):
        return legacy_any_fwd_cuda(q, k, v, kv_len, None, causal, window, with_lse=False)[0]
    o, _ = launch_fwd(q, k, v, kv_len, None, causal, window, False, n_split)
    legacy_fwd_cuda.launches += 1
    return o


legacy_fwd_cuda.launches = 0


def flash_attention(q, k, v, kv_len=None, causal: bool = False, window: int = -1, block_q: int = 256,
                    block_k: int = 1024) -> torch.Tensor:
    """softmax(q k^T / sqrt(D) [+ masks]) v for q [B, H, Lq, D], k/v
    [B, H, Lk, D] and kv_len [B] (all Lk when None); returns [B, H, Lq, D]
    in q's dtype. The JAX signature (``interpret`` aside): ``block_q`` and
    ``block_k`` are accepted and change nothing, since this function has no
    dropout hash seeded by the JAX blocks and the CUDA kernel picks its own
    tiles. CPU tensors take the plain version, CUDA tensors launch L1."""
    del block_q, block_k
    kv_len = kv_len_tensor(kv_len, q, k.shape[2])
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_len, causal, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CPU or CUDA tensors, got {q.device}")
    return legacy_fwd_cuda(q.contiguous(), k.contiguous(), v.contiguous(), kv_len, causal, window)
