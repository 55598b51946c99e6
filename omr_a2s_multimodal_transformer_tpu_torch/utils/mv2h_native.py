"""Native MV2H: dependency-free implementation of the MV2H transcription
metric (McLeod & Steedman, "Evaluating automatic polyphonic music
transcription", ISMIR 2018) over **kern token sequences.

Why this exists: the reference scores MV2H through music21 -> MIDI ->
pyMV2H (reference src/utils/metrics.py:94-338). Where neither dependency
is installed, this module makes MV2H computable: a small kern interpreter
(the same dialect our tokenizer emits — GRANDSTAFF two-spine piano kern) renders
each sequence to a timed note list at a fixed 120 bpm tempo map (matching
music21's default for tempo-less kern), and the five MV2H components are
computed per the paper:

  - multi-pitch  : F1 over notes matched by (pitch, onset within 50 ms)
  - voice        : F1 over consecutive same-voice note pairs ("links")
                   reproduced by the matched transcription notes
  - meter        : F1 over the metrical hierarchy's time points
                   (sub-beat / beat / downbeat grids, 50 ms tolerance)
  - note value   : mean over matched notes of
                   max(0, 1 - |dur_t - dur_g| / dur_g)
  - harmony      : kern carries no chord/key annotations, so the harmony
                   component is undefined on this data; it is EXCLUDED
                   from the native mv2h average by default (reported as
                   None), rather than silently scored 0 or 1.

This is a faithful reimplementation of the published metric, NOT a
bit-parity port of pyMV2H (whose MIDI round-trip quantizes differently);
``utils/metrics.py`` takes the pyMV2H route of utils/mv2h.py when its
dependencies are installed.
Both prediction and ground truth pass through the same interpreter, so
systematic dialect choices cancel.

Port of ``omr_a2s_multimodal_transformer_tpu/utils/mv2h_native.py``, line
for line.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from omr_a2s_multimodal_transformer_tpu_torch.utils.mv2h import seq2kern_lines

ONSET_TOL_S = 0.050  # MV2H standard onset tolerance
QUARTER_S = 0.5  # 120 bpm fixed tempo map (music21 default for bare kern)

_STEP_SEMITONES = {"c": 0, "d": 2, "e": 4, "f": 5, "g": 7, "a": 9, "b": 11}
_NOTE_RE = re.compile(r"(\d+)(\.*)([a-gA-G]+|r+)([n#-]*)")


@dataclass
class Note:
    pitch: int  # MIDI
    onset: float  # seconds
    duration: float  # seconds
    voice: int


def _kern_pitch_to_midi(letters: str, acc: str) -> Optional[int]:
    ch = letters[0]
    if ch.lower() == "r":
        return None  # rest
    step = _STEP_SEMITONES[ch.lower()]
    if ch.islower():
        midi = 60 + 12 * (len(letters) - 1) + step
    else:
        midi = 60 - 12 * len(letters) + step
    midi += acc.count("#") - acc.count("-")
    return midi


def _token_duration_s(digits: str, dots: str) -> float:
    d = int(digits)
    if d == 0:
        ql = 8.0  # breve
    else:
        ql = 4.0 / d
    ql *= 2.0 - 0.5 ** len(dots)
    return ql * QUARTER_S


def kern_to_notes(lines: Sequence[str]) -> Tuple[List[Note], List[float], float]:
    """Interpret kern lines -> (notes, barline times, total duration).

    Each spine keeps its own time cursor (kern semantics: '.' = no new
    event in this spine; a spine's onset is the sum of its own previous
    durations). Ties ('[' opens, ']' closes) merge into one long note.
    Grace notes (q) get zero duration and are skipped; multirests rr\\d+
    advance time. Unparseable tokens are ignored (broad tolerance, like
    the reference's exception-swallowing, metrics.py:312-314)."""
    n_spines = max((len(ln.split("\t")) for ln in lines if ln.strip()), default=0)
    cursors = [0.0] * n_spines
    notes: List[Note] = []
    open_ties: Dict[Tuple[int, int], int] = {}  # (spine, pitch) -> notes index
    bar_times: List[float] = []

    for ln in lines:
        if not ln.strip():
            continue
        cols = ln.split("\t")
        if cols[0].startswith("**") or cols[0].startswith("*"):
            continue
        if cols[0].startswith("="):
            bar_times.append(max(cursors[: len(cols)] or [0.0]))
            # re-sync spines at barlines (barlines are simultaneities)
            t = max(cursors[: len(cols)] or [0.0])
            for i in range(len(cols)):
                cursors[i] = t
            continue
        for spine, col in enumerate(cols):
            col = col.strip()
            if col in (".", ""):
                continue
            # multirest
            mm = re.match(r"^rr(\d+)$", col)
            if mm:
                cursors[spine] += int(mm.group(1)) * 4 * QUARTER_S
                continue
            chord_dur = 0.0
            for tok in col.split(" "):
                if "q" in tok:  # grace note: no time
                    continue
                tie_open = "[" in tok
                tie_close = "]" in tok
                m = _NOTE_RE.search(tok)
                if not m:
                    continue
                dur = _token_duration_s(m.group(1), m.group(2))
                chord_dur = max(chord_dur, dur)
                midi = _kern_pitch_to_midi(m.group(3), m.group(4))
                if midi is None:
                    continue  # rest: advances time only
                key = (spine, midi)
                if tie_close and key in open_ties:
                    notes[open_ties.pop(key)].duration += dur
                    if tie_open:  # middle of a tie chain
                        open_ties[key] = len(notes) - 1
                    continue
                notes.append(Note(midi, cursors[spine], dur, voice=spine))
                if tie_open:
                    open_ties[key] = len(notes) - 1
            cursors[spine] += chord_dur
    total = max(cursors, default=0.0)
    return notes, bar_times, total


def _match_notes(gt: List[Note], pred: List[Note]) -> List[Tuple[int, int]]:
    """Greedy one-to-one matching by (equal pitch, onset within 50 ms),
    closest onset first."""
    cands = []
    for i, g in enumerate(gt):
        for j, p in enumerate(pred):
            if g.pitch == p.pitch and abs(g.onset - p.onset) <= ONSET_TOL_S:
                cands.append((abs(g.onset - p.onset), i, j))
    cands.sort()
    used_g, used_p, pairs = set(), set(), []
    for _, i, j in cands:
        if i in used_g or j in used_p:
            continue
        used_g.add(i)
        used_p.add(j)
        pairs.append((i, j))
    return pairs


def _f1(tp: int, n_pred: int, n_gt: int) -> float:
    if n_pred == 0 and n_gt == 0:
        return 1.0
    p = tp / n_pred if n_pred else 0.0
    r = tp / n_gt if n_gt else 0.0
    return 2 * p * r / (p + r) if (p + r) else 0.0


def _voice_links(notes: List[Note], idx: Sequence[int]) -> set:
    """Consecutive-pair links within each voice, over the given note
    indices, as frozensets of index pairs ordered by onset."""
    by_voice: Dict[int, List[int]] = {}
    for i in idx:
        by_voice.setdefault(notes[i].voice, []).append(i)
    links = set()
    for v, ids in by_voice.items():
        ids.sort(key=lambda i: (notes[i].onset, notes[i].pitch))
        for a, b in zip(ids, ids[1:]):
            links.add((a, b))
    return links


def _metrical_grid(bar_times: List[float], total: float) -> List[Tuple[int, float]]:
    """(level, time) points: level 2 = downbeat (barlines), 1 = beat
    (quarters), 0 = sub-beat (eighths)."""
    pts = [(2, t) for t in bar_times]
    t, n = 0.0, 0
    while t <= total + 1e-9:
        pts.append((1, t))
        t = QUARTER_S * (n := n + 1)
    t, n = 0.0, 0
    while t <= total + 1e-9:
        pts.append((0, t))
        t = QUARTER_S / 2 * (n := n + 1)
    return pts


def _grid_f1(gt_pts, pred_pts) -> float:
    used = set()
    tp = 0
    for lv, t in gt_pts:
        for k, (lv2, t2) in enumerate(pred_pts):
            if k in used or lv2 != lv:
                continue
            if abs(t - t2) <= ONSET_TOL_S:
                used.add(k)
                tp += 1
                break
    return _f1(tp, len(pred_pts), len(gt_pts))


def mv2h_from_kern_lines(gt_lines: Sequence[str], pred_lines: Sequence[str]) -> Dict[str, Optional[float]]:
    gt_notes, gt_bars, gt_total = kern_to_notes(gt_lines)
    pr_notes, pr_bars, pr_total = kern_to_notes(pred_lines)

    pairs = _match_notes(gt_notes, pr_notes)
    multi_pitch = _f1(len(pairs), len(pr_notes), len(gt_notes))

    # voice: GT links (over matched GT notes) reproduced as links in the
    # transcription's voice assignment of the matched counterparts
    g2p = dict(pairs)
    gt_links = _voice_links(gt_notes, [i for i, _ in pairs])
    pr_links = _voice_links(pr_notes, [j for _, j in pairs])
    mapped = {(g2p[a], g2p[b]) for a, b in gt_links}
    tp = len(mapped & pr_links)
    voice = _f1(tp, len(pr_links), len(gt_links))

    meter = _grid_f1(_metrical_grid(gt_bars, gt_total), _metrical_grid(pr_bars, pr_total))

    if pairs:
        acc = 0.0
        for i, j in pairs:
            g, p = gt_notes[i], pr_notes[j]
            if g.duration <= 0:
                acc += 1.0 if p.duration <= 0 else 0.0
            else:
                acc += max(0.0, 1.0 - abs(p.duration - g.duration) / g.duration)
        note_value = acc / len(pairs)
    else:
        note_value = 1.0 if not gt_notes and not pr_notes else 0.0

    comps = {"multi-pitch": multi_pitch, "voice": voice, "meter": meter,
             "note_value": note_value, "harmony": None}
    present = [v for v in comps.values() if v is not None]
    comps["mv2h"] = sum(present) / len(present)
    return comps


def compute_mv2h_metrics_native(
    y_true: Sequence[List[str]], y_pred: Sequence[List[str]]
) -> Dict[str, Optional[float]]:
    """Corpus-level native MV2H over linearized token sequences (the same
    call shape as utils/mv2h.compute_mv2h_metrics). A sample whose kern
    reconstruction fails contributes 0, matching the reference's
    exception handling (metrics.py:312-314)."""
    fields = ("multi-pitch", "voice", "meter", "note_value", "mv2h")
    totals = dict.fromkeys(fields, 0.0)
    for t, h in zip(y_true, y_pred):
        try:
            res = mv2h_from_kern_lines(seq2kern_lines(t), seq2kern_lines(h))
            for k in fields:
                totals[k] += res[k] or 0.0
        except Exception:
            pass
    n = max(len(y_true), 1)
    out: Dict[str, Optional[float]] = {k: v / n for k, v in totals.items()}
    out["harmony"] = None  # undefined on kern (no chord annotations)
    return out
