"""Sample sources: HF Hub, local directory tree, and synthetic corpus.

Copy of ``omr_a2s_multimodal_transformer_tpu/data/sources.py``. A source
yields dict samples with keys:
  - 'transcript': raw kern/bekern text (str)
  - 'image':      a PIL image (``HFSource``, ``DirectorySource``) or a
                  uint8 [H, W] array (``SyntheticSource``); the frontend
                  (``frontends.preprocess_image``) takes either
  - 'audio':      {'array': np.ndarray float32, 'sampling_rate': int}

``HFSource`` mirrors the reference's ingest (its
``src/data/ar_dataset.py:233``, datasets
``PRAIG/{ds}-grandstaff-multimodal``) and needs the network or a local HF
cache. ``DirectorySource`` reads the on-disk layout produced by dataset
preparation (``composer/{img,img_distorted,krn,bekrn,wav}``) and decodes
its images with PIL. ``SyntheticSource`` renders a deterministic corpus
with numpy alone: the same pixels, audio and transcript as the JAX
package's for the same arguments.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

DATASETS = ["grandstaff", "beethoven", "chopin", "hummel", "joplin", "mozart", "scarlatti-d"]
SPLITS = ["train", "val", "test"]
MODALITIES = ["audio", "image", "both"]


class HFSource:
    """HuggingFace-datasets-backed source (needs network or a local HF cache)."""

    def __init__(self, ds_name: str, split: str, encoding: str = "bekern", use_distorted_images: bool = False):
        from datasets import load_dataset

        assert ds_name in DATASETS, f"Invalid dataset name: {ds_name}"
        assert split in SPLITS, f"Invalid split: {split}"
        self.ds = load_dataset(f"PRAIG/{ds_name}-grandstaff-multimodal", split=split)
        self.encoding = encoding
        self.image_key = "image_distorted" if use_distorted_images else "image"

    def __len__(self) -> int:
        return len(self.ds)

    def __getitem__(self, idx: int) -> Dict:
        s = self.ds[idx]
        return {"transcript": s[self.encoding], "image": s[self.image_key], "audio": s["audio"]}

    def transcripts(self) -> List[str]:
        return list(self.ds[self.encoding])


class DirectorySource:
    """Local grandstaff tree + partition files (one `composer\\tpiece` or
    `piece` line per sample, reference prepare_dataset.py:241-259)."""

    def __init__(
        self,
        root: str,
        ds_name: str,
        split: str,
        encoding: str = "bekern",
        use_distorted_images: bool = False,
    ):
        self.root = root
        self.encoding = encoding
        self.img_dir = "img_distorted" if use_distorted_images else "img"
        self.img_suffix = "_distorted.jpg" if use_distorted_images else ".jpg"
        part = os.path.join(root, "partitions", ds_name, f"{split}.txt")
        with open(part) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        self.items = []
        for ln in lines:
            composer, piece = ln.split("\t") if "\t" in ln else (ds_name, ln)
            self.items.append((composer, piece))

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int) -> Dict:
        from PIL import Image
        from scipy.io import wavfile

        composer, piece = self.items[idx]
        base = os.path.join(self.root, composer)
        krn_dir = "bekrn" if self.encoding == "bekern" else "krn"
        with open(os.path.join(base, krn_dir, piece + ("." + krn_dir))) as f:
            transcript = f.read()
        image = Image.open(os.path.join(base, self.img_dir, piece + self.img_suffix))
        sr, wave = wavfile.read(os.path.join(base, "wav", piece + ".wav"))
        if wave.dtype.kind == "i":
            wave = wave.astype(np.float32) / np.iinfo(wave.dtype).max
        if wave.ndim == 2:
            wave = wave.mean(axis=1)
        return {"transcript": transcript, "image": image, "audio": {"array": wave.astype(np.float32), "sampling_rate": int(sr)}}

    def transcripts(self) -> List[str]:
        out = []
        krn_dir = "bekrn" if self.encoding == "bekern" else "krn"
        for composer, piece in self.items:
            with open(os.path.join(self.root, composer, krn_dir, piece + "." + krn_dir)) as f:
                out.append(f.read())
        return out


_PITCHES = ["c", "d", "e", "f", "g", "a", "b", "cc", "dd", "ee", "C", "D", "E", "F", "G", "A", "B"]
_DURS = ["2", "4", "8", "16"]


def synthetic_kern(rng: np.random.Generator, n_measures: int = 4, notes_per_measure: int = 4) -> str:
    """Deterministic pseudo-score: 2 voices, clefs, meter, barlines, chords."""
    lines = ["**kern\t**kern", "*clefF4\t*clefG2", "*M4/4\t*M4/4"]
    for m in range(n_measures):
        lines.append(f"={m + 1}\t={m + 1}")
        for _ in range(notes_per_measure):
            def note():
                d = _DURS[rng.integers(len(_DURS))]
                p = _PITCHES[rng.integers(len(_PITCHES))]
                acc = ["", "#", "-"][rng.integers(3)]
                return f"{d}{p}{acc}"

            left = note() if rng.random() > 0.2 else "."
            right = note() + (" " + note() if rng.random() > 0.7 else "")
            lines.append(f"{left}\t{right}")
    lines.append("*-\t*-")
    return "\n".join(lines) + "\n"


import re as _re

_NOTE_RE = _re.compile(r"^(\d+)([a-gA-G]+)([#-]?)$")


def _parse_kern_events(transcript: str):
    """Parse a ``synthetic_kern`` score into a flat event list.

    Returns [(kind, payload)]: kind 'bar' (payload None) or 'notes'
    (payload = list over the two voices of lists of (dur:int,
    pitch_rank:int, acc:-1/0/+1); empty list = rest '.')."""
    events = []
    for line in transcript.strip().splitlines():
        if line.startswith(("**", "*")):
            continue
        cols = line.split("\t")
        if cols[0].startswith("="):
            events.append(("bar", None))
            continue
        voices = []
        for col in cols:
            notes = []
            if col != ".":
                for tok in col.split(" "):
                    m = _NOTE_RE.match(tok)
                    if m:
                        dur = int(m.group(1))
                        pitch = m.group(2)
                        rank = _PITCHES.index(pitch) if pitch in _PITCHES else 0
                        acc = {"#": 1, "-": -1}.get(m.group(3), 0)
                        notes.append((dur, rank, acc))
            voices.append(notes)
        events.append(("notes", voices))
    return events


def grand_geometry(h: int, w: int, n_events: int):
    """Shared renderer/oracle geometry for the 'grand' style: head half-size
    r, stem length, chord x-offset — all derived from (h, w, n_events) so the
    oracle (tools/oracle_synth_floor.py) can probe exact pixel boxes."""
    band_h = h // 2
    dx = max(1, w // max(1, n_events))
    r = max(3, min(band_h // 14, (dx - 2) // 4))
    return band_h, dx, r


def _render_grand(transcript: str, h: int, w: int) -> np.ndarray:
    """GRANDSTAFF-scale glyph rendering: same content-determinism as the
    'blob' style but with realistic glyph sizes and SHAPE-coded durations —
    the blob style's 2-8 px size-coded blobs are an unrealistically faint
    signal vs real GRANDSTAFF noteheads/stems (~10-40 px features).

    Glyph for (dur, pitch rank, accidental) at column cx, center row cy
    (cy encodes rank exactly as the blob style):
      dur 2:  hollow 2r x 2r head (2 px border)
      dur 4:  filled 2r x 2r head
      dur 8:  filled head + 2 px stem, 2r tall, at the head's right edge
      dur 16: ... + an r-wide flag at the stem top
      acc #:  2 px vertical bar left of the head, UPPER half (cy-r..cy)
      acc -:  same bar, LOWER half (cy..cy+r)
    A chord note vertically within 2r+4 px of an already-placed head is
    shifted right by 2r+4 (like engraved seconds)."""
    img = np.full((h, w), 255, dtype=np.uint8)
    events = _parse_kern_events(transcript)
    if not events:
        return img
    band_h, dx, r = grand_geometry(h, w, len(events))
    stem = 2 * r
    for v in range(2):
        top = h - (v + 1) * band_h
        for line in range(5):
            y = top + int(band_h * (0.2 + 0.15 * line))
            img[y : y + 1, :] = 200  # faint staff
    for e, (kind, payload) in enumerate(events):
        x = min(e * dx + dx // 2, w - 2)
        if kind == "bar":
            img[:, x : x + max(1, dx // 8 + 1)] = 0
            continue
        for v, notes in enumerate(payload):
            top = h - (v + 1) * band_h
            placed = []  # cy of already-drawn heads (chord collision rule)
            for dur, rank, acc in notes:
                frac = 0.85 - 0.7 * rank / max(1, len(_PITCHES) - 1)
                cy = top + int(band_h * frac)
                cx = x
                if any(abs(cy - p) < 2 * r + 4 for p in placed):
                    cx = x + 2 * r + 4
                placed.append(cy)
                y0, y1 = cy - r, cy + r
                x0, x1 = cx - r, cx + r
                img[max(0, y0):y1, max(0, x0):x1] = 0
                if dur == 2:  # hollow head
                    img[max(0, y0 + 2):y1 - 2, max(0, x0 + 2):x1 - 2] = 255
                if dur in (8, 16):  # stem
                    img[max(0, y0 - stem):y0, max(0, x1 - 2):x1] = 0
                if dur == 16:  # flag
                    img[max(0, y0 - stem):max(0, y0 - stem + 3), x1:min(w, x1 + r)] = 0
                if acc > 0:
                    img[max(0, y0):cy, max(0, x0 - 4):max(0, x0 - 2)] = 0
                elif acc < 0:
                    img[cy:y1, max(0, x0 - 4):max(0, x0 - 2)] = 0
    return img


def render_score_image(transcript: str, h: int, w: int, style: str = "blob") -> np.ndarray:
    """CONTENT-DETERMINISTIC toy notation: every kern token is legible from
    the pixels, so a correct model can actually generalize on the synthetic
    corpus (val/test use different generator seeds than train —
    convergence-to-good-SER runs depend on this; a purely random image
    would make generalization impossible regardless of model quality).

    Layout: one column span per event (barlines = full-height vertical
    lines). Two voice bands (voice 0 bottom, voice 1 top), 5 faint staff
    lines each. A note is a filled blob whose VERTICAL position encodes the
    pitch rank, whose SIZE encodes the duration class (2,4,8,16), and an
    accidental tick above (#) or below (-) the blob.

    style='grand' switches to GRANDSTAFF-scale glyphs (_render_grand)."""
    if style == "grand":
        return _render_grand(transcript, h, w)
    if style != "blob":
        raise ValueError(f"unknown render style {style!r}: use 'blob' or 'grand'")
    img = np.full((h, w), 255, dtype=np.uint8)
    events = _parse_kern_events(transcript)
    if not events:
        return img
    n_v = 2
    band_h = h // n_v
    for v in range(n_v):
        top = h - (v + 1) * band_h  # voice 0 = bottom band
        for line in range(5):
            y = top + int(band_h * (0.2 + 0.15 * line))
            img[y : y + 1, :] = 200  # faint staff
    dx = max(1, w // max(1, len(events)))
    dur_to_size = {2: 4, 4: 3, 8: 2, 16: 1}
    for e, (kind, payload) in enumerate(events):
        x = min(e * dx + dx // 2, w - 2)
        if kind == "bar":
            img[:, x : x + max(1, dx // 8 + 1)] = 0
            continue
        for v, notes in enumerate(payload):
            top = h - (v + 1) * band_h
            for dur, rank, acc in notes:
                # pitch rank -> y within the band (high rank = high pitch = up)
                frac = 0.85 - 0.7 * rank / max(1, len(_PITCHES) - 1)
                cy = top + int(band_h * frac)
                r = dur_to_size.get(dur, 2)
                r = max(1, min(r, band_h // 6 + 1))
                y0, y1 = max(0, cy - r), min(h, cy + r)
                x0, x1 = max(0, x - r), min(w, x + r)
                img[y0:y1, x0:x1] = 0
                if acc and y0 - 2 >= 0 and y1 + 2 <= h:
                    if acc > 0:
                        img[y0 - 2 : y0 - 1, x0:x1] = 0  # sharp: tick above
                    else:
                        img[y1 + 1 : y1 + 2, x0:x1] = 0  # flat: tick below
    return img


def bands_tone_bin(voice: int, chord_i: int, rank: int, acc: int) -> int:
    """STFT bin index of a note in the 'bands' audio style (see below).

    Three disjoint 60-bin bands by simultaneity group (left voice / right
    chord note 1 / right chord note 2); within a band, bin = 3*rank +
    (acc+1). Injective over (group, rank, acc) and only one tone ever
    sounds per band, so the per-band argmax bin IS the code."""
    band = 15 + 60 * (0 if voice == 0 else 1 + min(chord_i, 1))
    return band + 3 * rank + (acc + 1)


def render_score_audio(transcript: str, secs: float, sr: int = 22050,
                       style: str = "tones") -> np.ndarray:
    """Content-deterministic audio: each event occupies an equal time slot;
    every note contributes a tone whose FREQUENCY encodes the note identity
    and whose on-fraction of the slot encodes the duration class. Barlines
    are a short broadband click.

    style="tones" (default): musical mapping f0 = 110*2^(v + (rank +
    0.5*acc)/12). LOSSY: (rank, acc=+1) aliases exactly with (rank+1,
    acc=-1); the 17-rank span makes voice-1 notes alias voice-0 notes an
    octave up; and low-pitch semitones (6.5 Hz at 110 Hz) fall under the
    10.77 Hz bin width of the band-limited STFT (ops/stft.py) — a hard
    information ceiling measured as audio-only SER ~45 at corpus scale.

    style="bands": separable code. Simultaneity groups (left voice, right
    chord note 1, right chord note 2) get disjoint 60-bin bands; within a
    band each (rank, acc) maps to a unique EXACT bin-center frequency
    (bin = band + 3*rank + acc+1, f = bin*sr/2048 matching ops/stft.py
    N_FFT). A bin-centered tone under the periodic Hann window lands in
    bins {k-1,k,k+1} only, and tones within a band are never simultaneous,
    so the encoding is injective and exactly peak-decodable (see
    tests/test_audio_bands.py roundtrip).
    """
    n = int(sr * secs)
    t = np.arange(n) / sr
    wave = np.zeros(n, dtype=np.float32)
    events = _parse_kern_events(transcript)
    if not events:
        return wave
    slot = secs / len(events)
    dur_to_frac = {2: 1.0, 4: 0.75, 8: 0.5, 16: 0.3}
    bin_hz = sr / 2048.0  # ops/stft.py N_FFT; exact bin centers
    for e, (kind, payload) in enumerate(events):
        t0 = e * slot
        i0 = int(t0 * sr)
        if kind == "bar":
            i1 = min(n, i0 + max(1, int(0.01 * sr)))
            wave[i0:i1] += 0.3 * np.sign(np.sin(2 * np.pi * 3000 * t[i0:i1])).astype(np.float32)
            continue
        for v, notes in enumerate(payload):
            for ci, (dur, rank, acc) in enumerate(notes):
                if style == "bands":
                    f0 = bands_tone_bin(v, ci, rank, acc) * bin_hz
                else:
                    f0 = 110.0 * (2.0 ** (v + (rank + 0.5 * acc) / 12.0))
                i1 = min(n, i0 + max(1, int(slot * dur_to_frac.get(dur, 0.5) * sr)))
                wave[i0:i1] += 0.15 * np.sin(2 * np.pi * f0 * t[i0:i1]).astype(np.float32)
    return wave


class SyntheticSource:
    """Deterministic miniature multimodal corpus (images + audio + kern).

    Rendering is CONTENT-DETERMINISTIC (see render_score_image /
    render_score_audio): the inputs encode the transcript, so train/val
    splits with different seeds measure true generalization."""

    def __init__(
        self,
        n: int = 16,
        seed: int = 0,
        img_height_range=(48, 64),
        img_width_range=(96, 160),
        audio_seconds_range=(0.5, 1.5),
        n_measures: int = 2,
        encoding: str = "kern",
        render_style: str = "blob",
        n_measures_range=None,
        audio_style: str = "tones",
    ):
        self.n = n
        self.seed = seed
        self.img_height_range = img_height_range
        self.img_width_range = img_width_range
        self.audio_seconds_range = audio_seconds_range
        self.n_measures = n_measures
        self.encoding = encoding
        self.render_style = render_style
        # Varied score lengths (GRANDSTAFF-realistic): n_measures_range
        # = [lo, hi] draws a per-sample measure count and scales width/audio
        # length with it, so short samples keep production glyph density.
        # A fixed-length corpus (every sample at max length/width) is the
        # HARDEST possible curriculum for cross-attention alignment
        # latching — mixed lengths are both more realistic and what lets
        # attention lock on early (measured: the fixed 30-measure corpus
        # plateaus at val SER ~46-52 with the model never reading the
        # image — mispaired-image teacher-forced loss equals paired).
        self.n_measures_range = tuple(n_measures_range) if n_measures_range else None
        # Audio encoding: "tones" (musical, aliasing-lossy) or "bands"
        # (separable, exactly decodable) — see render_score_audio.
        self.audio_style = audio_style

    def __len__(self) -> int:
        return self.n

    def _rng(self, idx: int) -> np.random.Generator:
        return np.random.default_rng(self.seed * 100003 + idx)

    def _measures(self, idx: int) -> int:
        if self.n_measures_range is None:
            return self.n_measures
        lo, hi = self.n_measures_range
        r = np.random.default_rng(self.seed * 100003 + idx + 15551)
        return int(r.integers(lo, hi + 1))

    def __getitem__(self, idx: int) -> Dict:
        # Transcript uses a FRESH generator so it matches transcripts()
        # regardless of how many draws the image/audio below consume.
        n_m = self._measures(idx)
        transcript = synthetic_kern(self._rng(idx), n_measures=n_m)
        rng = np.random.default_rng(self.seed * 100003 + idx + 7919)
        # img_width_range/audio_seconds_range describe a NOMINAL
        # self.n_measures-long score; scale by the drawn count so glyph
        # density (px and seconds per event) stays constant across lengths.
        scale = n_m / max(1, self.n_measures)
        h = int(rng.integers(*self.img_height_range))
        w = max(32, int(round(int(rng.integers(*self.img_width_range)) * scale)))
        img = render_score_image(transcript, h, w, style=self.render_style)
        secs = max(0.2, float(rng.uniform(*self.audio_seconds_range)) * scale)
        wave = render_score_audio(transcript, secs, style=self.audio_style)
        return {
            "transcript": transcript,
            "image": img,
            "audio": {"array": wave, "sampling_rate": 22050},
        }

    def transcripts(self) -> List[str]:
        return [synthetic_kern(self._rng(i), n_measures=self._measures(i)) for i in range(self.n)]


def make_source(
    ds_name: str,
    split: str,
    encoding: str = "bekern",
    use_distorted_images: bool = False,
    data_root: Optional[str] = None,
    synthetic: bool = False,
    synthetic_kwargs: Optional[Dict] = None,
):
    """Source factory: synthetic -> local directory -> HF Hub."""
    if synthetic or ds_name == "synthetic":
        kw = dict(synthetic_kwargs or {})
        # Optional per-split sizes: long convergence runs want a big train
        # split but cheap val/test decodes (n_val/n_test override n).
        n_val, n_test = kw.pop("n_val", None), kw.pop("n_test", None)
        if split == "val" and n_val is not None:
            kw["n"] = n_val
        if split == "test" and n_test is not None:
            kw["n"] = n_test
        kw.setdefault("encoding", encoding)
        kw.setdefault("seed", {"train": 1, "val": 2, "test": 3}[split])
        return SyntheticSource(**kw)
    if data_root is not None and os.path.isdir(os.path.join(data_root, "partitions")):
        return DirectorySource(data_root, ds_name, split, encoding, use_distorted_images)
    return HFSource(ds_name, split, encoding, use_distorted_images)
