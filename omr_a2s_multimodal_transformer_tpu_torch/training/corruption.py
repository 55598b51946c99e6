"""Teacher-forcing token corruption (port of
``omr_a2s_multimodal_transformer_tpu/training/corruption.py``)."""

from __future__ import annotations

import torch


def corrupt_tokens(generator: torch.Generator, y_in: torch.Tensor, vocab_size: int, prob: float,
                   pad_id: int = 0) -> torch.Tensor:
    """[B, L] ids -> ids where each non-pad token is replaced, with
    probability ``prob``, by a uniform id over the full vocab (pad included,
    as in the reference)."""
    if prob <= 0.0:
        return y_in
    flip = torch.rand(y_in.shape, generator=generator, device=y_in.device) < prob
    random_ids = torch.randint(0, vocab_size, y_in.shape, generator=generator, device=y_in.device,
                               dtype=y_in.dtype)
    return torch.where(flip & (y_in != pad_id), random_ids, y_in)
