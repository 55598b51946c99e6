"""Loss functions (port of ``omr_a2s_multimodal_transformer_tpu/training/losses.py``)."""

from __future__ import annotations

import torch


def cross_entropy_ignore_pad(logits: torch.Tensor, targets: torch.Tensor, pad_id: int = 0) -> torch.Tensor:
    """Token-level cross-entropy with ignore_index=pad, mean over non-pad
    tokens. logits [B, L, V] in any float dtype (log-sum-exp in f32);
    targets [B, L]."""
    xf = logits.float()
    t = targets.long()
    lse = torch.logsumexp(xf, dim=-1)
    tgt_logit = xf.gather(-1, t[..., None])[..., 0]
    mask = (targets != pad_id).float()
    return ((lse - tgt_logit) * mask).sum() / mask.sum().clamp_min(1.0)
