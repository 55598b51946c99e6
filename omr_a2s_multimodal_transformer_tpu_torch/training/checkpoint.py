"""Checkpointing: torch save/restore with the JAX package's hparams sidecar.

Port of ``save_checkpoint``, ``load_hparams`` and ``restore_checkpoint``
from ``omr_a2s_multimodal_transformer_tpu/training/checkpoint.py``. A
checkpoint is a directory per tag holding ``state.pt`` (a dict: the
model's ``state_dict`` under "params", the optimizer's under "opt_state",
and "step") and the ``hparams.json`` sidecar that rebuilds the model
without the original CLI flags. Both files are written to a temporary name
and moved into place with ``os.replace``, so a reader never sees half a
file. The multimodal split and stitch are not ported yet.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

HPARAMS_FILE = "hparams.json"
STATE_FILE = "state.pt"


def _replace_into(path: str, write) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    write(tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str, state: Dict[str, Any], hparams: Optional[Dict] = None) -> None:
    """Atomic save of ``state`` (tensors and plain values) + JSON hparams sidecar."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    _replace_into(os.path.join(path, STATE_FILE), lambda tmp: torch.save(state, tmp))
    if hparams is not None:
        def write_hparams(tmp):
            with open(tmp, "w") as f:
                json.dump(hparams, f, indent=1, default=str)

        _replace_into(os.path.join(path, HPARAMS_FILE), write_hparams)


def load_hparams(path: str) -> Dict:
    with open(os.path.join(os.path.abspath(path), HPARAMS_FILE)) as f:
        return json.load(f)


def restore_checkpoint(path: str, map_location: Any = "cpu") -> Dict[str, Any]:
    """The saved state dict, its tensors on ``map_location``."""
    return torch.load(os.path.join(os.path.abspath(path), STATE_FILE), map_location=map_location,
                      weights_only=True)
