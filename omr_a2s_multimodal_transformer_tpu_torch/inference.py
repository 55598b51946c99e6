"""End-to-end image transcription (serving path).

Port of ``make_image_transcriber`` from
``omr_a2s_multimodal_transformer_tpu/inference.py``: raw uint8 score images
-> device preprocess (``ops/image.py``) -> conv-stem encode -> KV-cached
greedy decode -> token ids. The audio, multimodal and fused transcribers
are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from omr_a2s_multimodal_transformer_tpu_torch.device import DeviceLike, check_module_device
from omr_a2s_multimodal_transformer_tpu_torch.ops.image import preprocess_image_batch
from omr_a2s_multimodal_transformer_tpu_torch.training.decode import greedy_decode_fn


def make_image_transcriber(model, sos_id: int, eos_id: int, img_height: Optional[int] = None,
                           device: DeviceLike = None) -> Callable:
    """f(raw_u8 [B, H, W], hw [B, 2]) -> (tokens [B, L], scores).

    The model must live on ``device`` (``cuda`` unless the caller says
    otherwise); inputs are moved there. ``img_height`` (the resize) is not
    ported yet and raises when it differs from the image height.
    """
    dev = check_module_device(model, device)
    decode = greedy_decode_fn(model, model.max_seq_len, sos_id, eos_id)

    @torch.no_grad()
    def transcribe(raw: torch.Tensor, hw: torch.Tensor):
        x, hw2 = preprocess_image_batch(raw.to(dev), hw.to(dev), target_height=img_height)
        return decode(x, hw2)

    return transcribe
