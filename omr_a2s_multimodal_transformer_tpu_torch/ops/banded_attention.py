"""Banded (sliding-window) causal self-attention in plain PyTorch.

Port of ``omr_a2s_multimodal_transformer_tpu/ops/banded_attention.py``:
queries are cut into chunks of C >= window; each chunk attends to itself
and the previous chunk only ([B, n, H, C, 2C] logits), which is exact for
window <= C. Compute is O(L * 2C * D) instead of O(L^2 D), and autograd
differentiates it. The decoder takes it for windowed self-attention above
two chunks (``models/decoder.py``); the JAX package computes it in XLA,
outside any Pallas kernel, so it has no kernel here either.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from omr_a2s_multimodal_transformer_tpu_torch.parallel import mesh as mesh_lib

BAND_MASK = -1e9  # logit of a key outside the band (the JAX module's constant)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def band_chunk(window: int) -> int:
    """The chunk C of a window: the window rounded up to 128, at least 128."""
    return max(_round_up(window, 128), 128)


def banded_causal_attention(
    q: torch.Tensor,  # [B, L, H, Dh]
    k: torch.Tensor,  # [B, L, H, Dh]
    v: torch.Tensor,  # [B, L, H, Dh]
    window: int,
    key_bias: Optional[torch.Tensor] = None,  # [B, L] additive per-key bias (pad masking)
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    chunk: Optional[int] = None,
    heads_sharded: bool = False,
) -> torch.Tensor:
    """softmax over keys in [i - window, i] only; returns [B, L, H, Dh] in
    q's dtype. Equal to full attention under the windowed causal mask.
    Dropout on the weights (after the softmax) runs when a rate and a
    generator are given (this rank's slice of the global draw,
    ``parallel/mesh.py`` ``rand``; the heads' too when they are sharded)."""
    b, l, h, dh = q.shape
    c = chunk or band_chunk(window)
    if window > c:
        raise ValueError(f"window {window} must fit in chunk {c}")
    lp = _round_up(l, c)
    n = lp // c

    def chunks(x):
        return F.pad(x, (0, 0, 0, 0, 0, lp - l)).reshape(b, n, c, h, dh)

    qc, kc, vc = chunks(q), chunks(k), chunks(v)
    # previous chunk (zeros before chunk 0)
    k2 = torch.cat([F.pad(kc, (0, 0, 0, 0, 0, 0, 1, 0))[:, :n], kc], dim=2)  # [B, n, 2C, H, Dh]
    v2 = torch.cat([F.pad(vc, (0, 0, 0, 0, 0, 0, 1, 0))[:, :n], vc], dim=2)

    logits = torch.einsum("bnqhd,bnkhd->bnhqk", qc.float(), k2.float()) * (1.0 / dh ** 0.5)  # [B, n, H, C, 2C]

    # query i = n_idx*C + qi, key j = (n_idx-1)*C + kj: i - j = qi + C - kj
    qi = torch.arange(c, device=q.device)[:, None]
    kj = torch.arange(2 * c, device=q.device)[None, :]
    rel = qi + c - kj
    allowed = (rel >= 0) & (rel <= window)
    n_idx = torch.arange(n, device=q.device)[:, None, None]
    in_range = n_idx * c + (kj - c) >= 0  # chunk 0 has no previous chunk
    mask = allowed[None] & in_range  # [n, C, 2C]
    logits = torch.where(mask[None, :, None], logits, BAND_MASK)

    if key_bias is not None:
        kb = F.pad(key_bias.float(), (0, lp - l)).reshape(b, n, c)
        kb2 = torch.cat([F.pad(kb, (0, 0, 1, 0))[:, :n], kb], dim=2)  # [B, n, 2C]
        logits = logits + kb2[:, :, None, None, :]

    weights = torch.softmax(logits, dim=-1)
    if dropout_rate > 0.0 and generator is not None:
        keep = mesh_lib.rand(weights.shape, generator, weights.device,
                             model_dim=2 if heads_sharded else None) >= dropout_rate
        weights = torch.where(keep, weights / (1.0 - dropout_rate), 0.0)
    out = torch.einsum("bnhqk,bnkhd->bnqhd", weights.to(q.dtype).float(), v2.float()).to(q.dtype)
    return out.reshape(b, lp, h, dh)[:, :l]
