"""Host-side image/audio frontends (parity path).

Port of ``omr_a2s_multimodal_transformer_tpu/data/frontends.py``:
- image: grayscale, optional aspect-preserving resize to a target height,
  scale to [0, 1]; output [1, H, W] float32, the same values as the JAX
  package's ``preprocess_image`` (which calls PIL's ``convert("L")`` and
  ``resize``);
- audio: resample to 22.05 kHz, band-limited log-STFT in [0, 1]; output
  [1, 195, T] float32, ``ops/stft.py``'s numpy ``log_spectrogram_np``.

The grayscale conversion is numpy, so the synthetic corpus needs neither
PIL nor joblib: a uint8 L image passes through, and RGB takes PIL's own
integer ITU-R 601-2 luma. PIL is imported only for the ``img_height``
resize (PIL's bicubic, which the reference calls) and for PIL images of
other modes. There is no disk cache of frontend outputs: the data loader
computes each sample anew, so there is no cache entry that can go missing
and no fallback for one.

``spectrogram_shape`` gives ``preprocess_audio``'s output shape from the
waveform's length alone, which the max-lens scan needs.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from omr_a2s_multimodal_transformer_tpu_torch.ops.stft import HOP_LENGTH, NUM_FREQ_BINS, SAMPLE_RATE, log_spectrogram_np


def _require_pil(what: str):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{what} needs PIL (Pillow), which is not installed") from e
    return Image


def rgb_to_luma(rgb: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 3] -> uint8 [H, W]: PIL's ``convert("L")`` of an RGB
    image, L = (R * 19595 + G * 38470 + B * 7471 + 0x8000) >> 16."""
    c = rgb.astype(np.uint32)
    return ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471 + 0x8000) >> 16).astype(np.uint8)


def to_grayscale(raw_image) -> np.ndarray:
    """uint8 [H, W] of an image given as a uint8 [H, W] or [H, W, 3] array
    or as a PIL image."""
    if hasattr(raw_image, "convert"):  # a PIL image
        if raw_image.mode not in ("L", "RGB"):
            raw_image = raw_image.convert("L")
        raw_image = np.asarray(raw_image)
    arr = np.asarray(raw_image)
    if arr.dtype != np.uint8:
        raise TypeError(f"expected a uint8 image, got {arr.dtype}")
    if arr.ndim == 2:
        return arr
    if arr.ndim == 3 and arr.shape[2] == 3:
        return rgb_to_luma(arr)
    raise ValueError(f"expected an [H, W] or [H, W, 3] image, got shape {arr.shape}")


def preprocess_image(raw_image, img_height: Optional[int] = None) -> np.ndarray:
    """Image -> [1, H, W] float32 in [0, 1]."""
    gray = to_grayscale(raw_image)
    if img_height is not None:
        image = _require_pil("preprocess_image(img_height=...)").fromarray(gray)
        new_width = int(img_height * image.size[0] / image.size[1])
        gray = np.asarray(image.resize((new_width, img_height)))
    arr = np.asarray(gray, dtype=np.float32) / 255.0
    return arr[None, ...]


def spectrogram_shape(num_samples: int, sr: float) -> Tuple[int, int]:
    """(bins, frames) of ``preprocess_audio``'s output for a waveform of
    num_samples at sr: resampled to 22.05 kHz by a polyphase filter
    (ceil(n * up / down) samples), then a centered STFT of hop 512."""
    if int(sr) != SAMPLE_RATE:
        g = math.gcd(int(sr), SAMPLE_RATE)
        up, down = SAMPLE_RATE // g, int(sr) // g
        num_samples = -(-num_samples * up // down)
    return NUM_FREQ_BINS, 1 + num_samples // HOP_LENGTH


def preprocess_audio(raw_audio: np.ndarray, sr: float) -> np.ndarray:
    """Waveform -> [1, NUM_FREQ_BINS, T] float32 log-spectrogram in [0, 1]."""
    x = log_spectrogram_np(np.asarray(raw_audio, np.float32), sr=sr)
    return x[None, ...].astype(np.float32)
