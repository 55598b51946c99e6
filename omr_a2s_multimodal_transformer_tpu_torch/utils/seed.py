"""Determinism helpers (port of ``omr_a2s_multimodal_transformer_tpu/utils/seed.py``).

Seeds the host-side RNGs (python, numpy: shuffling), torch's default
generators, and PYTHONHASHSEED for reproducible dict ordering in
subprocesses. The port's dropout and token corruption still draw from
explicit ``torch.Generator``s, as the JAX package's draw from PRNG keys.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def seed_everything(seed: int = 42) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
