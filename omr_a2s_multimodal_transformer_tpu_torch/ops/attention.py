"""Multi-head attention core (plain PyTorch).

Port of ``omr_a2s_multimodal_transformer_tpu/ops/attention.py``.
Head-split layout is [B, L, H, Dh]; masks are additive and broadcastable
to [B, H, Lq, Lk]. ``attend_packed_single_query`` also reads the quantized
cross K/V of the decoder's int8 and int4 caches: int8 codes as
``torch.int8``, int4 codes as two nibbles a ``uint8`` (``pack_int4``).
"""

from __future__ import annotations

from typing import Optional

import torch

from omr_a2s_multimodal_transformer_tpu_torch.parallel import mesh as mesh_lib


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
    heads_sharded: bool = False,
) -> torch.Tensor:
    """softmax(q k^T / sqrt(dh) + mask) v in float32; returns q's dtype.

    Dropout on the attention weights (after the softmax, torch MHA
    semantics) runs when a rate and a generator are given; its bits are
    this rank's slice of the global draw (``parallel/mesh.py`` ``rand``),
    the heads too when they are sharded over 'model'.
    """
    dh = q.shape[-1]
    out_dtype = q.dtype
    qf, kf, vf = q.float(), k.float(), v.float()
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * (1.0 / dh ** 0.5)
    if mask is not None:
        logits = logits + mask.float()
    weights = torch.softmax(logits, dim=-1)
    if dropout_rate > 0.0 and generator is not None:
        keep = mesh_lib.rand(weights.shape, generator, weights.device,
                             model_dim=1 if heads_sharded else None) >= dropout_rate
        weights = torch.where(keep, weights / (1.0 - dropout_rate), 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", weights, vf)
    return out.to(out_dtype)


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """int8 codes in [-8, 7], [..., D] with D even -> uint8 [..., D/2]: the
    even channel in the low nibble, the odd channel in the high one."""
    c = codes.to(torch.uint8) & 0xF
    return c[..., 0::2] | (c[..., 1::2] << 4)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [..., D/2] of ``pack_int4`` -> int8 codes [..., D], each nibble
    sign-extended (an arithmetic shift of the nibble in the top bits)."""
    lo = (packed << 4).view(torch.int8) >> 4
    hi = packed.view(torch.int8) >> 4
    return torch.stack((lo, hi), dim=-1).flatten(-2)


def attend_packed_single_query(
    q: torch.Tensor,  # [B, D]
    k_packed: torch.Tensor,  # [B, S, D] head-packed keys: float, int8 codes, or uint8 int4 pairs [B, S, D/2]
    v_packed: torch.Tensor,  # [B, S, D] head-packed values, the same storage as k_packed
    n_heads: int,
    mem_bias: Optional[torch.Tensor] = None,  # [B, S] (or [1, S]) additive
    k_scale: Optional[torch.Tensor] = None,  # [B, D] dequant scales (int8 and int4)
    v_scale: Optional[torch.Tensor] = None,  # [B, D]
    k_tscale: Optional[torch.Tensor] = None,  # [B, S] per-token scales (int4)
    v_tscale: Optional[torch.Tensor] = None,  # [B, S]
) -> torch.Tensor:
    """Single-query multi-head attention over head-packed K/V. Returns [B, D] float32.

    The query is rounded to the cache's dtype (bf16 for integer codes) as
    in the JAX version; the products accumulate in float32. Integer K/V
    (``k_scale`` given) keep their scales off the big arrays, as JAX folds
    them: q x k_scale in float32 before the query's rounding, the logits x
    k_tscale before the mask bias, the softmax weights x v_tscale before
    their rounding to bf16, the output x v_scale. The codes are read as
    bf16 (exact for |code| <= 127), one layer at a time.
    """
    if k_packed.dtype == torch.uint8:
        k_packed, v_packed = unpack_int4(k_packed), unpack_int4(v_packed)
    b, s, d = k_packed.shape
    dh = d // n_heads
    dt = k_packed.dtype if k_packed.dtype.is_floating_point else torch.bfloat16
    qf = q.float()
    if k_scale is not None:
        qf = qf * k_scale.float()
    qh = qf.to(dt).float().reshape(b, n_heads, dh)
    kh = k_packed.to(dt).float().reshape(b, s, n_heads, dh)
    logits = torch.einsum("bhd,bshd->bsh", qh, kh) * (1.0 / float(dh) ** 0.5)
    del kh
    if k_tscale is not None:
        logits = logits * k_tscale.float()[:, :, None]
    if mem_bias is not None:
        logits = logits + mem_bias.float()[:, :, None]
    w = torch.softmax(logits, dim=1)  # over S
    if v_tscale is not None:
        w = w * v_tscale.float()[:, :, None]
    w = w.to(dt).float()
    vh = v_packed.to(dt).float().reshape(b, s, n_heads, dh)
    out = torch.einsum("bsh,bshd->bhd", w, vh).reshape(b, d)
    if v_scale is not None:
        out = out * v_scale.float()
    return out
