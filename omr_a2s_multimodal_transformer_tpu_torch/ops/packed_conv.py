"""Width space-to-depth ("lane-packed") convolutions of the conv stem.

Port of ``omr_a2s_multimodal_transformer_tpu/ops/packed_conv.py``. A
packed tensor ``[B, H, W/f, f*C]`` is the NHWC ``[B, H, W, C]`` by a
reshape (width stays row-major within each packed cell, channel layout
(w-slot, c) with c minor). The JAX package packs to fill the TPU's
128-lane tiles and runs the convolutions with rearranged kernels
('widened': zero-widened; 'patched': neighbour columns gathered). Both are
relabelings of the same convolution on the same ``[kh, kw, ci, co]``
parameters, so here every mode unpacks, runs ``F.conv2d`` and repacks;
the modes are accepted, and rejected where JAX rejects them, so that a
caller sees the same contract.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def choose_pack_factor(width: int, max_factor: int = 8) -> int:
    """Largest f in {8, 4, 2, 1} (capped at max_factor) dividing ``width``."""
    for f in (8, 4, 2, 1):
        if f <= max_factor and width % f == 0:
            return f
    return 1


def pack_width(x: torch.Tensor, f: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, H, W//f, f*C]; channel layout (w-slot, c), c minor."""
    if f == 1:
        return x
    b, h, w, c = x.shape
    return x.reshape(b, h, w // f, f * c)


def repack_width(x: torch.Tensor, f_cur: int, f_new: int) -> torch.Tensor:
    """Change pack factor f_cur -> f_new (f_new | f_cur): a pure reshape."""
    if f_cur == f_new:
        return x
    b, h, wp, fc = x.shape
    c = fc // f_cur
    return x.reshape(b, h, wp * f_cur // f_new, f_new * c)


def unpack_width(x: torch.Tensor, f: int) -> torch.Tensor:
    """[B, H, Wp, f*C] -> [B, H, Wp*f, C] (the inverse of ``pack_width``)."""
    b, h, wp, fc = x.shape
    return x.reshape(b, h, wp * f, fc // f)


def _widened_right_pad(kw: int, f_in: int, f_out: int, sw: int, wp_in: int) -> int:
    """Right pad of the JAX 'widened' convolution (packed_conv.py:163-167):
    negative where that convolution would emit more columns than it should."""
    pw = kw // 2
    offs = [(q * sw + kx - pw) // f_in for q in range(f_out) for kx in range(kw)]
    dmin, dmax = min(offs), max(offs)
    w_out = (wp_in * f_in // sw) // f_out
    return (w_out - 1) * (f_out * sw // f_in) + (dmax - dmin + 1) + dmin - wp_in


def packed_conv(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    f_in: int,
    f_out: int,
    stride: Tuple[int, int],
    mode: str = "widened",
) -> torch.Tensor:
    """Packed-space equivalent of a conv with ``w`` at ``stride``, padding
    kh//2 and kw//2, in the promoted dtype of x and w.

    x: [B, H, Wp, f_in*ci]; w: HWIO [kh, kw, ci, co]; bias [co]; returns
    [B, H', Wp', f_out*co] with Wp' = (Wp*f_in // sw) // f_out, as JAX.
    ``mode`` ('widened', 'patched', 'auto') selects the TPU layout in JAX
    and changes nothing here; the geometry checks are JAX's.
    """
    sh, sw = stride
    kh, kw, ci, co = w.shape
    s_w = f_out * sw // f_in
    if s_w * f_in != f_out * sw:
        raise ValueError(f"non-integral packed stride: f_in={f_in} f_out={f_out} sw={sw}")
    if mode == "auto":
        mode = "patched" if (s_w == 1 and f_in > 1 and kw // 2 <= f_in) else "widened"
    b, h, wp_in, _ = x.shape
    if mode == "patched":
        if s_w != 1 or kw // 2 > f_in:
            raise ValueError(
                f"packed_conv mode='patched' needs packed-space stride 1 and "
                f"kw//2 <= f_in (f_in={f_in}, f_out={f_out}, stride={stride}, kernel={tuple(w.shape)})"
            )
    else:
        pr = _widened_right_pad(kw, f_in, f_out, sw, wp_in)
        if pr < 0:
            raise ValueError(
                f"packed_conv geometry yields negative right pad {pr} "
                f"(f_in={f_in}, f_out={f_out}, stride={stride}, kernel={tuple(w.shape)}, wp_in={wp_in})"
            )
    dt = torch.promote_types(x.dtype, w.dtype)
    xu = unpack_width(x, f_in).permute(0, 3, 1, 2)  # NCHW view of NHWC memory
    y = F.conv2d(xu.to(dt), w.permute(3, 2, 0, 1).to(dt), bias.to(dt), stride=(sh, sw), padding=(kh // 2, kw // 2))
    w_out = (wp_in * f_in // sw) // f_out
    y = y[..., : w_out * f_out].permute(0, 2, 3, 1)
    return pack_width(y.contiguous(), f_out)
