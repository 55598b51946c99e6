"""Attention mask construction (closed-form broadcasts).

Port of ``omr_a2s_multimodal_transformer_tpu/ops/masks.py``. Additive
masks are float tensors added to attention logits (0 = attend, NEG_INF =
blocked); boolean validity masks are True = valid.
"""

from __future__ import annotations

import torch

NEG_INF = -1e9  # finite stand-in for -inf (keeps softmax NaN-free when rows are fully blocked)


def windowed_causal_mask(length: int, window: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """[L, L] additive mask: position i attends to [max(0, i-window), i]; window <= 0 is plain causal."""
    i = torch.arange(length, device=device)[:, None]
    j = torch.arange(length, device=device)[None, :]
    allowed = j <= i
    if window > 0:
        allowed &= j >= i - window
    return torch.where(allowed, 0.0, NEG_INF).to(dtype)


def length_valid_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] lengths -> [B, max_len] bool, True where the position is valid."""
    return torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]


def rect_valid_mask(hw: torch.Tensor, grid_h: int, grid_w: int) -> torch.Tensor:
    """[B, 2] valid (h, w) in reduced units -> [B, grid_h * grid_w] bool
    over a row-major flatten of the [grid_h, grid_w] grid."""
    hh = torch.arange(grid_h, device=hw.device)[None, :, None]
    ww = torch.arange(grid_w, device=hw.device)[None, None, :]
    valid = (hh < hw[:, 0][:, None, None]) & (ww < hw[:, 1][:, None, None])
    return valid.reshape(valid.shape[0], grid_h * grid_w)


def key_padding_additive(valid: torch.Tensor, dtype=torch.float32, torch_float_parity: bool = False) -> torch.Tensor:
    """[B, S] bool validity -> [B, 1, 1, S] additive mask.

    torch_float_parity=True reproduces the reference's accidental float
    key-padding semantics: +1.0 on pads instead of blocking them.
    """
    pad_bias = 1.0 if torch_float_parity else NEG_INF
    return torch.where(valid, 0.0, pad_bias).to(dtype)[:, None, None, :]


def corner_attn_mask(q_valid: torch.Tensor, k_valid: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[B, Lq], [B, Lk] bool -> [B, 1, Lq, Lk] additive mask blocking only
    the (pad query x pad key) corner, the reference's CrossAttention
    semantics (its model.py:343-351): valid queries still see pad keys and
    vice versa."""
    blocked = (~q_valid)[:, :, None] & (~k_valid)[:, None, :]
    return torch.where(blocked, NEG_INF, 0.0).to(dtype)[:, None, :, :]
