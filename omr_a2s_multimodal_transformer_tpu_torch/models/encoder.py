"""Convolutional stem encoder.

Port of ``omr_a2s_multimodal_transformer_tpu/models/encoder.py``: 5
ConvBlocks (channels 1->16->32->64->128->128, strides (1,1), (2,2), (2,2),
(2,2), (2,1)) and 4 depthwise-separable DSCBlocks (128, 128, 128, 256) with
a residual add where shapes match. [B, H, W, 1] -> [B, H/16, W/8, 256].

The public boundary is NHWC like the JAX module. Inside, the convolutions
are ``F.conv2d`` on NCHW tensors kept in channels-last memory, so the NHWC
views the instance norm takes are free. Parameters carry the reference
PyTorch state_dict names (``conv_blocks.{i}.conv{j}``,
``dscblocks.{i}.conv{j}.{depth_conv,point_conv}``).

Dropout follows the JAX module's positioned MixDropout: per block one of
three sites is active; there a coin picks elementwise dropout (p) or
channel dropout (p/2). The elementwise draw is u8 bits against a 1/256
threshold and is shared by the three sites, as in the JAX version; the
bits come from a ``torch.Generator`` and so differ from ``jax.random``.
The width-packed stem (``packed_stem=True``, JAX ``PackedConvBlock`` and
``ops/packed_conv.py``) relabels the same convolutions on the same
[kh, kw, ci, co] parameters to fill the TPU's 128 lanes; it has no
counterpart on the GPU, so the port accepts the flag and runs these plain
convolutions (the JAX package holds packed equal to standard to 1e-9,
``tests/test_packed_stem.py``). ``remat=True`` recomputes each block's
activations in the backward (``models/remat.py``), as the JAX encoder's
``nn.remat`` blocks do: activation memory falls from the sum of the
stages' to the largest block's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from omr_a2s_multimodal_transformer_tpu_torch.models.remat import remat
from omr_a2s_multimodal_transformer_tpu_torch.ops.norm import instance_norm
from omr_a2s_multimodal_transformer_tpu_torch.parallel import mesh as mesh_lib

HEIGHT_REDUCTION = 16
WIDTH_REDUCTION = 8

# (out_ch, stride) per stage — as in the JAX encoder.
CONV_STAGES = ((16, (1, 1)), (32, (2, 2)), (64, (2, 2)), (128, (2, 2)), (128, (2, 1)))
DSC_STAGES = ((128, (1, 1)), (128, (1, 1)), (128, (1, 1)), (256, (1, 1)))
OUT_CHANNELS = 256


def conv2d(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv`` applied in the promoted dtype of x and its weight (flax's
    promotion rule: bf16 input and f32 weight run in f32)."""
    dt = torch.promote_types(x.dtype, conv.weight.dtype)
    bias = None if conv.bias is None else conv.bias.to(dt)
    return F.conv2d(x.to(dt), conv.weight.to(dt), bias, conv.stride, conv.padding, conv.dilation, conv.groups)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _norm(x: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
    return _nchw(instance_norm(_nhwc(x), eps=1e-3, valid=valid))


class MixDropout:
    """Positioned coin-flip dropout of one block (JAX ``MixDropout.site_factors``)."""

    def __init__(self, dropout_prob: float):
        self.p = dropout_prob
        self.p2d = dropout_prob / 2

    def site_factors(self, x: torch.Tensor, out_ch: int, stride: Tuple[int, int], generator: torch.Generator):
        """Three multiplicative NCHW factors (site 1, 2 at x's resolution,
        site 3 after the stride); exactly one differs from 1."""
        b, _, h, w = x.shape
        dev, dt = x.device, x.dtype
        pos = torch.randint(1, 4, (), generator=generator, device=dev)
        use_elem = torch.rand((), generator=generator, device=dev) < 0.5
        t = int(round((1.0 - self.p) * 256.0))
        bits = mesh_lib.randint(0, 256, (b, out_ch, h, w), generator, dev, dtype=torch.uint8)
        keep_e = bits < t if t < 256 else torch.ones_like(bits, dtype=torch.bool)
        keep_c = mesh_lib.rand((b, out_ch, 1, 1), generator, dev) < 1.0 - self.p2d
        f_elem = keep_e.to(dt) * (1.0 / (1.0 - self.p))
        f_chan = keep_c.to(dt) * (1.0 / (1.0 - self.p2d))
        h3, w3 = -(-h // stride[0]), -(-w // stride[1])

        def site(s, fe):
            return torch.where(pos == s, torch.where(use_elem, fe, f_chan), torch.ones((), dtype=dt, device=dev))

        return site(1, f_elem), site(2, f_elem), site(3, f_elem[:, :, :h3, :w3])


def _mul(x, f):
    return x if f is None else x * f


class ConvBlock(nn.Module):
    """3x Conv2d with instance norm and a positioned MixDropout."""

    def __init__(self, in_ch: int, out_ch: int, stride=(1, 1), dropout: float = 0.5):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv3 = nn.Conv2d(out_ch, out_ch, 3, padding=1, stride=stride)
        self.out_ch, self.stride, self.drop = out_ch, tuple(stride), MixDropout(dropout)

    def forward(self, x, generator=None, valid=None):
        f1 = f2 = f3 = None
        if generator is not None:
            f1, f2, f3 = self.drop.site_factors(x, self.out_ch, self.stride, generator)
        x = _mul(torch.relu(conv2d(x, self.conv1)), f1)
        x = _mul(torch.relu(conv2d(x, self.conv2)), f2)
        x = _norm(x, valid)
        return _mul(torch.relu(conv2d(x, self.conv3)), f3)


class DepthSepConv(nn.Module):
    """Depthwise 3x3 conv then 1x1 pointwise."""

    def __init__(self, in_ch: int, out_ch: int, stride=(1, 1)):
        super().__init__()
        self.depth_conv = nn.Conv2d(in_ch, in_ch, 3, stride=stride, padding=1, groups=in_ch)
        self.point_conv = nn.Conv2d(in_ch, out_ch, 1)

    def forward(self, x):
        return conv2d(conv2d(x, self.depth_conv), self.point_conv)


class DSCBlock(nn.Module):
    """3x depthwise-separable convs; the last has no activation."""

    def __init__(self, in_ch: int, out_ch: int, stride=(1, 1), dropout: float = 0.5):
        super().__init__()
        self.conv1 = DepthSepConv(in_ch, out_ch)
        self.conv2 = DepthSepConv(out_ch, out_ch)
        self.conv3 = DepthSepConv(out_ch, out_ch, stride=stride)
        self.out_ch, self.stride, self.drop = out_ch, tuple(stride), MixDropout(dropout)

    def forward(self, x, generator=None, valid=None):
        f1 = f2 = f3 = None
        if generator is not None:
            f1, f2, f3 = self.drop.site_factors(x, self.out_ch, self.stride, generator)
        x = _mul(torch.relu(self.conv1(x)), f1)
        x = _mul(torch.relu(self.conv2(x)), f2)
        x = _norm(x, valid)
        return _mul(self.conv3(x), f3)


def _shrink_valid(valid: Optional[torch.Tensor], stride) -> Optional[torch.Tensor]:
    """Track the valid-pixel mask through a strided conv (ceil semantics)."""
    if valid is None:
        return None
    sh, sw = stride
    return valid if (sh, sw) == (1, 1) else valid[:, ::sh, ::sw]


class ConvStemEncoder(nn.Module):
    """Full conv stem: [B, H, W, 1] -> [B, H/16, W/8, 256] (NHWC)."""

    def __init__(self, dropout: float = 0.5, masked_norm: bool = False, packed_stem: bool = False,
                 remat: bool = False):
        """``packed_stem`` is accepted for the JAX hparams and changes
        nothing: the same convolutions run either way (module docstring)."""
        super().__init__()
        self.dropout = dropout
        self.masked_norm = masked_norm
        self.remat = remat
        chans = [1] + [c for c, _ in CONV_STAGES]
        self.conv_blocks = nn.ModuleList(
            ConvBlock(chans[i], c, s, dropout) for i, (c, s) in enumerate(CONV_STAGES)
        )
        dchans = [CONV_STAGES[-1][0]] + [c for c, _ in DSC_STAGES]
        self.dscblocks = nn.ModuleList(
            DSCBlock(dchans[i], c, s, dropout) for i, (c, s) in enumerate(DSC_STAGES)
        )

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """generator=None is deterministic (no dropout); valid [B, H, W]
        bool is used only with masked_norm."""
        gen = generator if self.dropout > 0.0 else None
        v = valid if self.masked_norm else None
        x = _nchw(x).contiguous(memory_format=torch.channels_last)

        def run(blk, x, v):
            return remat(blk, gen, x, gen, v) if self.remat and torch.is_grad_enabled() else blk(x, gen, v)

        for blk, (_, stride) in zip(self.conv_blocks, CONV_STAGES):
            x = run(blk, x, v)
            v = _shrink_valid(v, stride)
        for blk, (_, stride) in zip(self.dscblocks, DSC_STAGES):
            xt = run(blk, x, v)
            x = x + xt if x.shape == xt.shape else xt  # residual when shapes match
            v = _shrink_valid(v, stride)
        return _nhwc(x)
