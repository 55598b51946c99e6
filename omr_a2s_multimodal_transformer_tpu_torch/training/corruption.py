"""Training-time stochastic curriculum (port of
``omr_a2s_multimodal_transformer_tpu/training/corruption.py``).

- Token corruption ("teacher forcing" in the reference's naming): with
  probability p, replace each non-pad decoder-input token with a uniform
  random vocab id, from a ``torch.Generator``.
- Modality dropout draw (reference model.py:561-575): with probability p
  use a single modality (50/50 image/audio) for this step. Drawn on the
  host from a numpy ``Generator``, the same draws as the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from omr_a2s_multimodal_transformer_tpu_torch.parallel import mesh as mesh_lib


def corrupt_tokens(generator: torch.Generator, y_in: torch.Tensor, vocab_size: int, prob: float,
                   pad_id: int = 0) -> torch.Tensor:
    """[B, L] ids -> ids where each non-pad token is replaced, with
    probability ``prob``, by a uniform id over the full vocab (pad included,
    as in the reference). The draws are this rank's rows of the global
    batch's (``parallel/mesh.py`` ``rand``)."""
    if prob <= 0.0:
        return y_in
    flip = mesh_lib.rand(y_in.shape, generator, y_in.device) < prob
    random_ids = mesh_lib.randint(0, vocab_size, y_in.shape, generator, y_in.device, dtype=y_in.dtype)
    return torch.where(flip & (y_in != pad_id), random_ids, y_in)


def draw_modality(rng: np.random.Generator, prob: float) -> str:
    """Host-side modality-dropout draw: 'image' | 'audio' | 'both'."""
    if rng.random() < prob:
        return "image" if rng.random() < 0.5 else "audio"
    return "both"
