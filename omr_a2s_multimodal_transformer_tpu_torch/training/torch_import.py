"""Reference PyTorch-Lightning checkpoints into the port.

Port of ``omr_a2s_multimodal_transformer_tpu/training/torch_import.py``.
The JAX package maps the reference state_dict onto its flax tree (OIHW to
HWIO, packed qkv split, Conv1d to Dense); the port keeps the reference's
module paths and layouts (``encoder.conv_blocks.{i}.conv{j}``,
``decoder.transformer_decoder.layers.{i}.self_attn.in_proj_weight``,
``decoder.out_layer`` as a Conv1d, ``cross_attn.attention.*``), so the
conversion is the identity on every parameter. Only the positional
encodings go: the reference keeps them as buffers (``decoder.pe``,
``pos_2d``, ``{image,audio}_pos_2d``), the port recomputes them.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

# buffers of the reference that the port recomputes (the positional encodings)
_PE_NAMES = ("pe", "pos_2d", "image_pos_2d", "audio_pos_2d", "pos_1d")


def _is_pe_buffer(key: str) -> bool:
    return key.rsplit(".", 1)[-1] in _PE_NAMES


def convert_state_dict(sd: Dict) -> Dict[str, torch.Tensor]:
    """Reference ``Transformer`` or ``MultimodalTransformer`` state_dict ->
    the port model's: every parameter as it is, the positional-encoding
    buffers left out (the JAX package's convert_unimodal_state_dict and
    convert_multimodal_state_dict)."""
    return {k: torch.as_tensor(v).detach().clone() for k, v in sd.items() if not _is_pe_buffer(k)}


def load_torch_checkpoint(path: str) -> Tuple[Dict, Dict]:
    """Load a Lightning .ckpt on the CPU -> (state_dict, hyper_parameters)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return ckpt["state_dict"], ckpt.get("hyper_parameters", {})
