"""End-to-end transcription (serving path).

Port of ``omr_a2s_multimodal_transformer_tpu/inference.py``: raw inputs
(uint8 score images / 22.05 kHz waveforms) -> device frontends
(``ops/image.py`` with its bicubic resize, ``ops/stft.py``'s float32
``log_spectrogram``) -> conv-stem encode -> KV-cached greedy decode, or
the weighted late fusion of two unimodal models -> token ids, all on the
models' device.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from omr_a2s_multimodal_transformer_tpu_torch.device import DeviceLike, check_module_device
from omr_a2s_multimodal_transformer_tpu_torch.ops.image import preprocess_image_batch
from omr_a2s_multimodal_transformer_tpu_torch.ops.stft import HOP_LENGTH, NUM_FREQ_BINS, log_spectrogram
from omr_a2s_multimodal_transformer_tpu_torch.training.decode import greedy_decode_fn, weighted_decode_fn


def make_image_transcriber(model, sos_id: int, eos_id: int, img_height: Optional[int] = None,
                           device: DeviceLike = None) -> Callable:
    """f(raw_u8 [B, H, W], hw [B, 2]) -> (tokens [B, L], scores).

    The model must live on ``device`` (``cuda`` unless the caller says
    otherwise); inputs are moved there. ``img_height`` resizes the batch to
    that height on the device (``ops/image.py``).
    """
    dev = check_module_device(model, device)
    decode = greedy_decode_fn(model, model.max_seq_len, sos_id, eos_id)

    @torch.no_grad()
    def transcribe(raw: torch.Tensor, hw: torch.Tensor):
        x, hw2 = preprocess_image_batch(raw.to(dev), hw.to(dev), target_height=img_height)
        return decode(x, hw2)

    return transcribe


def audio_batch(wave: torch.Tensor, n_samples: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """wave [B, L] (zero padded), n_samples [B] -> (spectrograms [B, 195, T, 1]
    laid out [bins (height), frames (width)] like the reference, NHWC;
    hw [B, 2] = (195, 1 + n_samples // 512))."""
    x = log_spectrogram(wave, n_samples)[..., None]
    frames = 1 + n_samples // HOP_LENGTH
    return x, torch.stack([torch.full_like(frames, NUM_FREQ_BINS), frames], dim=1)


def make_audio_transcriber(model, sos_id: int, eos_id: int, device: DeviceLike = None) -> Callable:
    """f(wave [B, L] f32, n_samples [B]) -> (tokens [B, L], scores), the
    model on ``device`` (``cuda`` unless the caller says otherwise)."""
    dev = check_module_device(model, device)
    decode = greedy_decode_fn(model, model.max_seq_len, sos_id, eos_id)

    @torch.no_grad()
    def transcribe(wave: torch.Tensor, n_samples: torch.Tensor):
        return decode(*audio_batch(wave.to(dev), n_samples.to(dev)))

    return transcribe


def make_multimodal_transcriber(model, sos_id: int, eos_id: int, img_height: Optional[int] = None,
                                device: DeviceLike = None) -> Callable:
    """f(raw_img_u8 [B, H, W], img_hw [B, 2], wave [B, L], n_samples [B]) ->
    (tokens, scores), the model on ``device`` (``cuda`` unless the caller
    says otherwise). ``img_height`` as in ``make_image_transcriber``."""
    dev = check_module_device(model, device)
    decode = greedy_decode_fn(model, model.max_seq_len, sos_id, eos_id, multimodal=True)

    @torch.no_grad()
    def transcribe(raw_img: torch.Tensor, img_hw: torch.Tensor, wave: torch.Tensor, n_samples: torch.Tensor):
        xi, hwi = preprocess_image_batch(raw_img.to(dev), img_hw.to(dev), target_height=img_height)
        xa, hwa = audio_batch(wave.to(dev), n_samples.to(dev))
        return decode(xi, hwi, xa, hwa)

    return transcribe


def make_fused_transcriber(img_model, audio_model, sos_id: int, eos_id: int, img_height: Optional[int] = None,
                           device: DeviceLike = None) -> Callable:
    """Weighted late-fusion serving path: two unimodal models decoded in
    lockstep, next-token dist = alpha*softmax(img) + (1-alpha)*softmax(audio)
    (reference weighted_multimodal/test.py:21-70).

    f(raw_img_u8 [B, H, W], img_hw [B, 2], wave [B, N] f32, n_samples [B],
      alpha) -> (tokens [B, L], scores), L the image model's max_seq_len.
    Both models must live on ``device`` (``cuda`` unless the caller says
    otherwise)."""
    dev, audio_dev = check_module_device(img_model, device), check_module_device(audio_model, device)
    if audio_dev != dev:
        raise ValueError(f"the audio model lives on {audio_dev}, the image model on {dev}")
    decode = weighted_decode_fn(img_model, audio_model, img_model.max_seq_len, sos_id, eos_id)

    @torch.no_grad()
    def transcribe(raw_img: torch.Tensor, img_hw: torch.Tensor, wave: torch.Tensor, n_samples: torch.Tensor,
                   alpha: float):
        xi, hwi = preprocess_image_batch(raw_img.to(dev), img_hw.to(dev), target_height=img_height)
        xa, hwa = audio_batch(wave.to(dev), n_samples.to(dev))
        return decode(xi, hwi, xa, hwa, alpha)

    return transcribe
