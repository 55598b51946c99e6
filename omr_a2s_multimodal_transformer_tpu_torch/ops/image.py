"""On-device image frontend: normalize + aspect-preserving resize.

Port of ``omr_a2s_multimodal_transformer_tpu/ops/image.py``
``preprocess_image_batch``. Raw uint8 images (right/bottom padded to a
static shape) are normalized to [0, 1] and optionally resized to a fixed
height on the device.

The resize is ``jax.image.resize(method="bicubic")``: JAX's
``scale_and_translate`` with the Keys cubic (a = -0.5), antialiased (on a
downscale the kernel widens by 1 / scale), one separable [in, out] weight
matrix per resized axis (``_weight_mat``, JAX's ``compute_weight_mat``),
applied as float32 products with TF32 off. ``F.interpolate(mode="bicubic")``
is another function (a = -0.75, no antialias).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

_EPS32 = float(torch.finfo(torch.float32).eps)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """R. G. Keys' cubic convolution kernel, a = -0.5, on |offsets| >= 0."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def _weight_mat(in_size: int, out_size: int, scale: float, device) -> torch.Tensor:
    """[in_size, out_size] float32 weights of one resized axis: samples at
    (i + 0.5) / scale - 0.5, the kernel widened by 1 / scale on a downscale,
    columns normalised by their sum (zeroed when it is <= 1000 eps) and
    zeroed where the sample falls outside [-0.5, in_size - 0.5]."""
    f32 = dict(dtype=torch.float32, device=device)
    inv_scale = 1.0 / torch.tensor(scale, **f32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = (torch.arange(out_size, **f32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, **f32)[:, None]).abs() / kernel_scale
    weights = _keys_cubic(x)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * _EPS32, weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


@contextlib.contextmanager
def _full_float32():
    """TF32 off for the products inside, whatever the caller set."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def resize_bicubic(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[B, H, W] float32 -> [B, height, width], ``jax.image.resize(x, (B,
    height, width), "bicubic")``; an axis whose size is unchanged is not
    touched."""
    _, h, w = x.shape
    with _full_float32():
        if height != h:
            x = torch.einsum("bhw,hH->bHw", x, _weight_mat(h, height, height / h, x.device))
        if width != w:
            x = torch.einsum("bhw,wW->bhW", x, _weight_mat(w, width, width / w, x.device))
    return x


def preprocess_image_batch(
    raw: torch.Tensor,  # [B, H, W] uint8 or float
    hw: torch.Tensor,  # [B, 2] valid (h, w) per sample
    target_height: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ([B, H', W', 1] float32 in [0, 1] padded with white, [B, 2] new hw).

    With target_height set, each image is resized to that height keeping its
    aspect, batched as one resize of the padded canvas (scale =
    target_height / H); the valid widths scale with it (rounded half to
    even, clipped to [1, W']) and the padding is forced back to white.
    """
    x = raw.to(torch.float32)
    if not raw.dtype.is_floating_point:  # 0..255 -> 0..1
        x = x / 255.0
    b, h, w = x.shape
    if target_height is not None and target_height != h:
        scale = target_height / h
        new_w = int(round(w * scale))
        x = resize_bicubic(x, target_height, new_w)
        scale32 = torch.tensor(scale, dtype=torch.float32, device=x.device)
        widths = torch.clamp(torch.round(hw[:, 1].to(torch.float32) * scale32), 1, new_w)
        hw = torch.stack([torch.full((b,), target_height, dtype=torch.int32, device=x.device),
                          widths.to(torch.int32)], dim=1)
        h, w = target_height, new_w
    hh = torch.arange(h, device=x.device)[None, :, None] < hw[:, 0][:, None, None]
    ww = torch.arange(w, device=x.device)[None, None, :] < hw[:, 1][:, None, None]
    x = torch.where(hh & ww, x.clamp(0.0, 1.0), 1.0)
    return x[..., None], hw
