"""Multi-head attention core (plain PyTorch).

Port of ``omr_a2s_multimodal_transformer_tpu/ops/attention.py`` for float
K/V. Head-split layout is [B, L, H, Dh]; masks are additive and
broadcastable to [B, H, Lq, Lk]. The int8/int4 cache branches of
``attend_packed_single_query`` are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch


def split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, l, d = x.shape
    return x.reshape(b, l, n_heads, d // n_heads)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, l, h, dh = x.shape
    return x.reshape(b, l, h * dh)


def attend(
    q: torch.Tensor,  # [B, Lq, H, Dh]
    k: torch.Tensor,  # [B, Lk, H, Dh]
    v: torch.Tensor,  # [B, Lk, H, Dh]
    mask: Optional[torch.Tensor] = None,  # additive, broadcastable to [B, H, Lq, Lk]
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """softmax(q k^T / sqrt(dh) + mask) v in float32; returns q's dtype.

    Dropout on the attention weights (after the softmax, torch MHA
    semantics) runs when a rate and a generator are given.
    """
    dh = q.shape[-1]
    out_dtype = q.dtype
    qf, kf, vf = q.float(), k.float(), v.float()
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * (1.0 / dh ** 0.5)
    if mask is not None:
        logits = logits + mask.float()
    weights = torch.softmax(logits, dim=-1)
    if dropout_rate > 0.0 and generator is not None:
        keep = torch.rand(weights.shape, generator=generator, device=weights.device) >= dropout_rate
        weights = torch.where(keep, weights / (1.0 - dropout_rate), 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", weights, vf)
    return out.to(out_dtype)


def attend_packed_single_query(
    q: torch.Tensor,  # [B, D]
    k_packed: torch.Tensor,  # [B, S, D] head-packed keys (float, stored dtype)
    v_packed: torch.Tensor,  # [B, S, D] head-packed values
    n_heads: int,
    mem_bias: Optional[torch.Tensor] = None,  # [B, S] (or [1, S]) additive
) -> torch.Tensor:
    """Single-query multi-head attention over head-packed K/V. Returns [B, D] float32.

    The query is rounded to the cache's dtype as in the JAX version; the
    products accumulate in float32.
    """
    if not k_packed.dtype.is_floating_point:
        raise NotImplementedError("int8/int4 cross K/V caches are not ported yet")
    b, s, d = k_packed.shape
    dh = d // n_heads
    qh = q.float().to(k_packed.dtype).float().reshape(b, n_heads, dh)
    kh = k_packed.float().reshape(b, s, n_heads, dh)
    vh = v_packed.float().reshape(b, s, n_heads, dh)
    logits = torch.einsum("bhd,bshd->bsh", qh, kh) * (1.0 / float(dh) ** 0.5)
    if mem_bias is not None:
        logits = logits + mem_bias.float()[:, :, None]
    w = torch.softmax(logits, dim=1)  # over S
    w = w.to(k_packed.dtype).float()
    out = torch.einsum("bsh,bshd->bhd", w, vh)
    return out.reshape(b, d)
