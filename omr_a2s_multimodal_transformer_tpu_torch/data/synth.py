"""Dependency-free kern -> WAV synthesis (FluidSynth fallback).

Copy of ``omr_a2s_multimodal_transformer_tpu/data/synth.py`` (host numpy;
the kern interpreter is the port's ``utils/mv2h_native.py``): the same
WAV bytes.

The reference renders dataset audio as kern -> MIDI (music21) -> WAV
(FluidSynth + a Yamaha-grand SoundFont) at 22.05 kHz
(reference src/data/prepare_dataset.py:100-162). Neither music21 nor
fluidsynth is installable in a zero-egress environment, which left the
audio-synthesis stage structurally complete but never able to produce an
actual WAV here. This module closes that gap natively:

  kern lines --kern_to_notes (utils/mv2h_native)--> timed MIDI note list
             --additive piano-ish rendering (numpy)--> float32 waveform
             --stdlib ``wave``--> 16-bit PCM WAV on disk

The voice is a damped harmonic stack (6 partials, 1/h^1.5 amplitudes,
per-note exponential decay with a key-scaled time constant and a 5 ms
attack ramp) — not a SoundFont-accurate piano, but a real, band-rich
acoustic rendering of the score whose spectrogram carries the same
note-onset/pitch structure the downstream audio frontend (ops/stft.py
log-STFT, 195 mel-free bins) consumes. Tempo map matches the native MV2H
interpreter: fixed 120 bpm (music21's default for tempo-less kern).

Synthesis failures (no parseable notes) raise, so the caller
(``prepare_dataset.synthesize_audio``) applies the reference's
error-logging + sibling-deletion semantics uniformly across engines.
"""

from __future__ import annotations

import wave as _wave
from typing import Sequence

import numpy as np

from omr_a2s_multimodal_transformer_tpu_torch.utils.mv2h_native import Note, kern_to_notes

__all__ = ["notes_to_wave", "render_kern_to_wav", "kern_lines_to_wave"]

_N_PARTIALS = 6
_ATTACK_S = 0.005
_RELEASE_TAIL_S = 0.35  # let the last note ring out


def _midi_to_hz(midi: int) -> float:
    return 440.0 * 2.0 ** ((midi - 69) / 12.0)


def notes_to_wave(
    notes: Sequence[Note], total_s: float, sample_rate: int = 22050
) -> np.ndarray:
    """Render a timed note list to a float32 waveform in [-1, 1]."""
    n = int(round((max(total_s, 0.0) + _RELEASE_TAIL_S) * sample_rate))
    out = np.zeros(max(n, 1), dtype=np.float64)
    for note in notes:
        f0 = _midi_to_hz(note.pitch)
        # ring past the nominal duration, but never past the buffer
        ring = min(note.duration + _RELEASE_TAIL_S, max(total_s - note.onset, 0.0) + _RELEASE_TAIL_S)
        i0 = int(round(note.onset * sample_rate))
        ns = int(round(ring * sample_rate))
        if ns <= 0 or i0 >= out.size:
            continue
        ns = min(ns, out.size - i0)
        t = np.arange(ns, dtype=np.float64) / sample_rate
        # decay constant: high keys die faster (piano-like), long notes
        # sustain a bit longer
        tau = np.clip(0.9 * (440.0 / f0) ** 0.35, 0.15, 1.5)
        env = np.exp(-t / tau)
        env *= np.minimum(t / _ATTACK_S, 1.0)  # attack ramp
        sig = np.zeros(ns, dtype=np.float64)
        nyq = sample_rate / 2.0
        for h in range(1, _N_PARTIALS + 1):
            fh = f0 * h
            if fh >= nyq:
                break
            sig += (h ** -1.5) * np.sin(2.0 * np.pi * fh * t)
        out[i0:i0 + ns] += 0.2 * env * sig
    peak = float(np.max(np.abs(out)))
    if peak > 0.9:
        out *= 0.9 / peak
    return out.astype(np.float32)


def kern_lines_to_wave(lines: Sequence[str], sample_rate: int = 22050) -> np.ndarray:
    """kern lines -> waveform. Raises ValueError if nothing parses to a note
    (the 'failed parse' signal the dataset-prep error path expects)."""
    notes, _, total = kern_to_notes(list(lines))
    if not notes:
        raise ValueError("no parseable notes in kern input")
    return notes_to_wave(notes, total, sample_rate)


def render_kern_to_wav(
    krn_path: str, wav_path: str, sample_rate: int = 22050
) -> None:
    """Read a .krn file, synthesize, write 16-bit PCM WAV (mono)."""
    with open(krn_path) as f:
        lines = f.read().splitlines()
    waveform = kern_lines_to_wave(lines, sample_rate)
    pcm = np.clip(waveform * 32767.0, -32768, 32767).astype(np.int16)
    with _wave.open(wav_path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
