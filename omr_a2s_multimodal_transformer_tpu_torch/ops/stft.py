"""Log-amplitude STFT frontend: the band-limited DFT as two matmuls.

Port of ``omr_a2s_multimodal_transformer_tpu/ops/stft.py``. The reference
computes the audio frontend with librosa on the host: STFT with n_fft
2048, hop 512, periodic Hann window, centered with zero padding, the 195
frequency bins below 2093 Hz, amplitude to dB relative to the per-sample
max with an 80 dB floor, rescaled to [0, 1].

The numpy host path (``log_spectrogram_np`` and its parts) is a copy of the
JAX package's: the data loader runs it, and it defines the values. The
batched device path ``log_spectrogram`` computes the same function on
[B, L] waveforms as ``frames @ C`` and ``frames @ S`` with the [n_fft, 195]
cos/sin matrices, as the JAX version does with XLA matmuls (there is no
Pallas kernel here to port). It runs in true float32: a TF32 or bf16 pass
loses ~1e-3 relative accuracy, which the log scale blows up near its
-80 dB floor, so TF32 is switched off around the two matmuls.

This module is the one home of the frontend's constants (SAMPLE_RATE,
HOP_LENGTH, NUM_FREQ_BINS, ...).
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 22050
N_FFT = 2048
HOP_LENGTH = 512
WIN_LENGTH = 2048
STFT_FMAX = 2093.0
# Bins with freq k*sr/n_fft <= 2093 Hz -> k = 0..194 -> 195 bins
# (reference preprocessing.py:13 NUM_FREQ_BINS = 195).
NUM_FREQ_BINS = int(math.floor(STFT_FMAX * N_FFT / SAMPLE_RATE)) + 1
AMIN = 1e-5
TOP_DB = 80.0


def hann_window(n: int = WIN_LENGTH, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window (scipy ``get_window('hann', n, fftbins=True)``)."""
    k = np.arange(n)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)).astype(dtype)


@functools.lru_cache(maxsize=4)
def _dft_matrices(n_fft: int = N_FFT, n_bins: int = NUM_FREQ_BINS):
    """Cos/sin DFT analysis matrices [n_fft, n_bins] for the kept band."""
    n = np.arange(n_fft)[:, None]  # time index
    k = np.arange(n_bins)[None, :]  # bin index
    ang = 2.0 * np.pi * n * k / n_fft
    # Match FFT convention X[k] = sum_n x[n] * exp(-2j pi n k / N).
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


def num_frames(num_samples: int, hop: int = HOP_LENGTH) -> int:
    """Frame count of a centered STFT: 1 + floor(len / hop)."""
    return 1 + num_samples // hop


def _frame_centered_np(y: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    pad = n_fft // 2
    ypad = np.pad(y, (pad, pad), mode="constant")
    t = 1 + (len(ypad) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(t)[:, None]
    return ypad[idx]  # [T, n_fft]


def magnitude_stft_np(y: np.ndarray) -> np.ndarray:
    """|STFT| of a 1-D signal, band-limited to NUM_FREQ_BINS. [bins, T]."""
    frames = _frame_centered_np(np.asarray(y, np.float32), N_FFT, HOP_LENGTH)
    frames = frames * hann_window()[None, :]
    c, s = _dft_matrices()
    re = frames @ c
    im = frames @ s
    return np.sqrt(re * re + im * im).T  # [bins, T]


def amplitude_to_db_np(mag: np.ndarray, amin: float = AMIN, top_db: float = TOP_DB) -> np.ndarray:
    """librosa.amplitude_to_db(S, ref=np.max): dB rel. per-array max, floored."""
    power = np.square(np.maximum(mag, amin))
    ref = np.square(max(amin, float(mag.max())))
    db = 10.0 * np.log10(power) - 10.0 * np.log10(ref)
    return np.maximum(db, db.max() - top_db)


def log_spectrogram_np(y: np.ndarray, sr: float = SAMPLE_RATE) -> np.ndarray:
    """Full reference frontend on the host: resample -> |STFT| -> dB -> [0,1].

    Returns [NUM_FREQ_BINS, T] float32 (reference
    ``get_spectrogram_from_raw_audio``, preprocessing.py:17-30).
    """
    y = np.asarray(y, dtype=np.float32)
    if int(sr) != SAMPLE_RATE:
        y = resample_np(y, int(sr), SAMPLE_RATE)
    db = amplitude_to_db_np(magnitude_stft_np(y))
    return (db / TOP_DB + 1.0).astype(np.float32)


def resample_np(y: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (GRANDSTAFF wavs are synthesized at 22.05 kHz, so
    this is an identity in the reference pipeline; provided for completeness)."""
    if orig_sr == target_sr:
        return y
    from scipy.signal import resample_poly

    g = math.gcd(orig_sr, target_sr)
    return resample_poly(y, target_sr // g, orig_sr // g).astype(np.float32)


# --------------------------------------------------------------------------
# Device path: batched, static shapes.
# --------------------------------------------------------------------------


@contextlib.contextmanager
def _no_tf32():
    """Full float32 matmuls on CUDA for the duration (restores the setting)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def log_spectrogram(wave: torch.Tensor, valid_samples: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched log-STFT frontend on the waveforms' device.

    Args:
      wave: [B, L] waveforms at 22.05 kHz, zero padded on the right (cast
        to float32).
      valid_samples: optional [B] integer true lengths. The per-sample dB
        reference (max) is taken over valid frames only, so right padding
        never changes the normalization (the reference's unpadded host
        computation).

    Returns:
      [B, NUM_FREQ_BINS, T] float32 in [0, 1], T = 1 + L // 512; frames
      past the valid region are exactly 0.0, the collate's pad value for
      spectrograms.
    """
    wave = wave.to(torch.float32)
    dev = wave.device
    pad = N_FFT // 2
    frames = F.pad(wave, (pad, pad)).unfold(1, N_FFT, HOP_LENGTH)  # [B, T, n_fft], T = 1 + L // hop
    frames = frames * torch.from_numpy(hann_window()).to(dev)
    c, s = (torch.from_numpy(m).to(dev) for m in _dft_matrices())
    with _no_tf32():
        re = frames @ c
        im = frames @ s
    mag = torch.sqrt(re * re + im * im)  # [B, T, bins]

    t = mag.shape[1]
    if valid_samples is not None:
        nf = 1 + valid_samples.to(dev) // HOP_LENGTH  # true frame counts
        frame_valid = torch.arange(t, device=dev)[None, :] < nf[:, None]  # [B, T]
        ref = torch.where(frame_valid[..., None], mag, 0.0).amax(dim=(1, 2)).clamp_min(AMIN)  # [B]
    else:
        frame_valid = torch.ones((wave.shape[0], t), dtype=torch.bool, device=dev)
        ref = mag.amax(dim=(1, 2)).clamp_min(AMIN)

    power_db = 20.0 * torch.log10(mag.clamp_min(AMIN))
    db = power_db - 20.0 * torch.log10(ref)[:, None, None]
    # per-sample max of db is 0 by construction (ref = max) -> floor at -80
    db = db.clamp_min(-TOP_DB)
    out = torch.where(frame_valid[..., None], db / TOP_DB + 1.0, 0.0)
    return out.transpose(1, 2).contiguous()  # [B, bins, T]
