"""Instance normalization (NHWC) with optional validity masking.

Port of ``omr_a2s_multimodal_transformer_tpu/ops/norm.py``
``instance_norm`` and ``instance_norm_packed``: per-sample, per-channel
normalization over the spatial dims, biased variance, no affine, eps 1e-3
in the stem. Statistics are taken in float32 as E[x^2] - E[x]^2; the
normalization itself runs in the input dtype, as in the JAX version.
"""

from __future__ import annotations

from typing import Optional

import torch


def instance_norm(x: torch.Tensor, eps: float = 1e-3, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [B, H, W, C] (any strides); valid: optional [B, H, W] bool (True = real pixel)."""
    dtype = x.dtype
    stat = torch.promote_types(dtype, torch.float32)
    xs = x.to(stat)
    if valid is None:
        mean = xs.mean(dim=(1, 2), keepdim=True)
        mean_sq = xs.square().mean(dim=(1, 2), keepdim=True)
    else:
        m = valid[..., None].to(stat)
        n = m.sum(dim=(1, 2), keepdim=True).clamp_min(1.0)
        mean = (xs * m).sum(dim=(1, 2), keepdim=True) / n
        mean_sq = (xs.square() * m).sum(dim=(1, 2), keepdim=True) / n
    var = (mean_sq - mean.square()).clamp_min(0.0)
    inv = torch.rsqrt(var + eps)
    return (x - mean.to(dtype)) * inv.to(dtype)


def instance_norm_packed(x: torch.Tensor, f: int, eps: float = 1e-3,
                         valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Instance norm over a width-packed tensor (``ops/packed_conv.py``),
    port of the JAX ``instance_norm_packed``: x [B, H, W/f, f*C] is the
    NHWC [B, H, W, C] by a reshape, so its statistics per original channel
    over (H, W/f, slot) are ``instance_norm``'s on that tensor; valid is the
    original-resolution [B, H, W] mask."""
    b, h, wp, fc = x.shape
    return instance_norm(x.reshape(b, h, wp * f, fc // f), eps=eps, valid=valid).reshape(b, h, wp, fc)
