"""Debug-mode numerical checking.

Port of ``omr_a2s_multimodal_transformer_tpu/utils/debug.py``, where
``jax.experimental.checkify`` makes a NaN/Inf or an out-of-bounds index
raise with its location. The port has no checkify: under the same switch
(``OMR_A2S_DEBUG_CHECKS=1``) the train step (``training/train_state.py``)
and the decodes (``training/decode.py``) check what those checks would
catch there, and raise:

- a non-finite loss or gradient (``FloatingPointError``);
- a token id outside [0, vocab) fed to the embedding, or emitted
  (``IndexError``);
- non-finite decode logits (``FloatingPointError``).

Each check reads a value on the host, so it costs a device sync: enable
the switch only while debugging. The switch is read when a step or a
decode function is built.
"""

from __future__ import annotations

import os
from typing import Iterable

import torch


def debug_checks_enabled() -> bool:
    return os.environ.get("OMR_A2S_DEBUG_CHECKS", "0") not in ("0", "", "false")


def check_finite(what: str, tensors: Iterable[torch.Tensor]) -> None:
    """Raise FloatingPointError naming ``what`` if any tensor holds a NaN or an Inf."""
    for i, t in enumerate(tensors):
        if t is not None and t.is_floating_point() and not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"debug check: non-finite values in {what} (tensor {i}, shape "
                                     f"{tuple(t.shape)})")


def check_token_ids(what: str, ids: torch.Tensor, vocab_size: int) -> None:
    """Raise IndexError if a token id lies outside [0, vocab_size)."""
    if ids.numel() and (bool((ids < 0).any()) or bool((ids >= vocab_size).any())):
        raise IndexError(f"debug check: {what} holds token ids outside [0, {vocab_size}): min "
                         f"{int(ids.min())}, max {int(ids.max())}")
