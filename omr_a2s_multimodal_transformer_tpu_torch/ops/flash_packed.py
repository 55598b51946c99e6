"""Head-packed flash attention with attention-weight dropout.

Port of ``omr_a2s_multimodal_transformer_tpu/ops/flash_packed.py`` for the
non-causal path the decoder's cross-attention takes. q is [B, Lq, H*64]
and k/v are [B, Lk, H*64]; per head h,

    o = (softmax(q_h k_h^T / sqrt(64)) * M / (1 - rate)) v_h

with keys masked where ``kv_valid`` is False or ``k >= kv_len`` (their
score becomes -1e30) and M the dropout keep-mask, applied after the
softmax (torch MHA semantics).

Two routes, chosen by where the tensors lie, never by a switch:

- CUDA tensors go through ``FlashAttention`` (a ``torch.autograd.Function``)
  whose forward launches kernel K1 (``csrc/flash_fwd.cu``) and whose
  backward launches K2 (``csrc/flash_bwd.cu``). There is no fallback: a
  kernel that does not build or launch raises.
- CPU tensors go through ``flash_attention_plain``, the same function as
  dense masked softmax in PyTorch, differentiated by autograd.

The keep-mask is a pure function of (seed, b, h, q, k): the counter hash
of the JAX kernel's interpret mode evaluated on global indices at the JAX
mask geometry (``mask_geometry``). Both routes therefore apply the masks
that ``export_keep_masks(..., interpret=True)`` of the JAX package returns,
bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from omr_a2s_multimodal_transformer_tpu_torch.ops import cuda_build

NEG_INF = -1e30
HEAD_DIM = 64
KERNEL_TILE = 64  # rows per tile in both CUDA kernels
MASK_BQ, MASK_BK = 128, 2048  # the decoder's JAX block sizes, which seed the keep-mask hash
_U32 = 0xFFFFFFFF


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def mask_geometry(lq: int, lk: int) -> Tuple[int, int]:
    """(bq, bk) blocks of the decoder's JAX kernel at (lq, lk): the
    keep-mask's hash is seeded per block of this geometry."""
    return min(MASK_BQ, _round_up(lq, 128)), min(MASK_BK, _round_up(lk, 128))


def dropout_threshold(rate: float) -> int:
    """Keep where the 32-bit hash is >= this (as in the JAX kernel)."""
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 tensors holding uint32 values, without
    overflowing int64: split c into 16-bit halves."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def keep_mask(seed: int, batch: int, n_heads: int, lq: int, lk: int, rate: float, device=None) -> torch.Tensor:
    """[B, H, Lq, Lk] bool keep-mask of the flash kernels (True = keep)."""
    bq, bk = mask_geometry(lq, lk)
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


def flash_attention_plain(q, k, v, kv_len, kv_valid, seed, dropout_rate: float = 0.0, n_heads: int = 4):
    """Plain PyTorch version of K1 (autograd gives K2's function).

    Returns (o [B, Lq, H*Dh] in q's dtype, lse [B, H, Lq] f32). Scores,
    softmax and dropout are float32; p is rounded to the input dtype before
    the PV product, as the kernels do. A row with no valid key averages v
    over the Lk keys (no NaN); the JAX kernel averages over its padded Lk.
    """
    b, lq, pd = q.shape
    lk = k.shape[1]
    dh = pd // n_heads
    qh, kh, vh = (_heads(t.float(), n_heads) for t in (q, k, v))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * (1.0 / dh ** 0.5)
    valid = kv_valid.bool() & (torch.arange(lk, device=q.device)[None, :] < kv_len[:, None])
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)  # not exp(s - lse): -1e30 + log(Lk) rounds to -1e30 in a row with no valid key
    if dropout_rate > 0.0:
        keep = keep_mask(int(seed), b, n_heads, lq, lk, dropout_rate, q.device)
        p = torch.where(keep, p / _keep_den(dropout_rate), 0.0)
    p = p.to(v.dtype).float()
    o = torch.matmul(p, vh).transpose(1, 2).reshape(b, lq, pd)
    return o.to(q.dtype), lse


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


def flash_fwd_cuda(q, k, v, kv_len, kv_valid, seed, dropout_rate, n_heads, mask_bq, mask_bk):
    """Launch K1. Returns (o bf16 [B, Lq, H*64], lse f32 [B, H, Lq])."""
    _check_cuda_inputs(q, k, v, kv_len, kv_valid, seed, n_heads, mask_bq, mask_bk)
    b, lq, pd = q.shape
    lk = k.shape[1]
    o = torch.empty_like(q)
    lse = torch.empty((b, n_heads, lq), device=q.device, dtype=torch.float32)
    fn = cuda_build.load("flash_fwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(), kv_valid.data_ptr(),
             seed.data_ptr(), o.data_ptr(), lse.data_ptr(), b, n_heads, lq, lk, mask_bq, mask_bk,
             float(dropout_rate), _keep_scale(dropout_rate), dropout_threshold(dropout_rate), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError {err}")
    flash_fwd_cuda.launches += 1
    return o, lse


flash_fwd_cuda.launches = 0


def flash_bwd_cuda(q, k, v, kv_len, kv_valid, seed, o, lse, do, dropout_rate, n_heads, mask_bq, mask_bk):
    """Launch K2. Returns (dq, dk, dv) bf16. delta = rowsum(do * o) per
    head is a PyTorch expression, as it is XLA outside the TPU kernel."""
    _check_cuda_inputs(q, k, v, kv_len, kv_valid, seed, n_heads, mask_bq, mask_bk)
    b, lq, pd = q.shape
    lk = k.shape[1]
    if do.shape != q.shape or o.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} and o {tuple(o.shape)} must have q's shape {tuple(q.shape)}")
    if lse.dtype != torch.float32 or lse.shape != (b, n_heads, lq) or not lse.is_contiguous() \
            or lse.device != q.device:
        raise ValueError("lse must be a contiguous float32 [B, H, Lq] tensor on q's device")
    do = do.to(torch.bfloat16).contiguous()
    delta = (do.float() * o.float()).reshape(b, lq, n_heads, pd // n_heads).sum(-1).transpose(1, 2).contiguous()
    dq_acc = torch.zeros((b, lq, pd), device=q.device, dtype=torch.float32)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    fn = cuda_build.load("flash_bwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(), kv_valid.data_ptr(),
             seed.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq_acc.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), b, n_heads, lq, lk, mask_bq, mask_bk,
             float(dropout_rate), _keep_scale(dropout_rate), dropout_threshold(dropout_rate), stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd launch failed: cudaError {err}")
    flash_bwd_cuda.launches += 1
    return dq_acc.to(q.dtype), dk, dv


flash_bwd_cuda.launches = 0


class FlashAttention(torch.autograd.Function):
    """K1 forward, K2 backward; saves q, k, v, o and lse (no score tensor)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, kv_valid, seed, dropout_rate, n_heads, mask_bq, mask_bk):
        o, lse = flash_fwd_cuda(q, k, v, kv_len, kv_valid, seed, dropout_rate, n_heads, mask_bq, mask_bk)
        ctx.save_for_backward(q, k, v, kv_len, kv_valid, seed, o, lse)
        ctx.cfg = (dropout_rate, n_heads, mask_bq, mask_bk)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, kv_len, kv_valid, seed, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd_cuda(q, k, v, kv_len, kv_valid, seed, o, lse, do, *ctx.cfg)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention_packed(q, k, v, kv_len, kv_valid, seed, dropout_rate: float = 0.0, n_heads: int = 4):
    """Differentiable packed flash attention; returns o [B, Lq, H*Dh].

    q [B, Lq, H*Dh], k/v [B, Lk, H*Dh], kv_len [B] int32, kv_valid [B, Lk]
    bool, seed a one-element int32 tensor (dropout stream id; unused at
    rate 0). The keep-mask follows the JAX mask geometry
    (``mask_geometry``), not the CUDA tile. CPU tensors take the plain
    version; CUDA tensors launch the kernels.
    """
    if q.device.type == "cpu":
        o, _ = flash_attention_plain(q, k, v, kv_len, kv_valid, seed, dropout_rate, n_heads)
        return o
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on CPU or CUDA tensors, got {q.device}")
    o, _ = FlashAttention.apply(q, k, v, kv_len, kv_valid, seed, dropout_rate, n_heads,
                                *mask_geometry(q.shape[1], k.shape[1]))
    return o
