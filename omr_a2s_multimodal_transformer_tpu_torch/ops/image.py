"""On-device image frontend: u8 -> [0, 1], padding forced to white.

Port of ``omr_a2s_multimodal_transformer_tpu/ops/image.py``
``preprocess_image_batch`` without its resize branch. The JAX resize is
``jax.image.resize(method="bicubic")``: a Keys cubic with a = -0.5 that
antialiases when it downscales. ``F.interpolate(mode="bicubic")`` is a
different function (a = -0.75, no antialias), so the resize waits for its
own port and ``target_height`` raises here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def preprocess_image_batch(
    raw: torch.Tensor,  # [B, H, W] uint8 or float
    hw: torch.Tensor,  # [B, 2] valid (h, w) per sample
    target_height: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ([B, H, W, 1] float32 in [0, 1] padded with white, [B, 2] hw)."""
    if target_height is not None and target_height != raw.shape[1]:
        raise NotImplementedError("the bicubic resize of preprocess_image_batch is not ported yet")
    x = raw.to(torch.float32)
    if not raw.dtype.is_floating_point:  # 0..255 -> 0..1
        x = x / 255.0
    _, h, w = x.shape
    hh = torch.arange(h, device=x.device)[None, :, None] < hw[:, 0][:, None, None]
    ww = torch.arange(w, device=x.device)[None, None, :] < hw[:, 1][:, None, None]
    x = torch.where(hh & ww, x.clamp(0.0, 1.0), 1.0)
    return x[..., None], hw
