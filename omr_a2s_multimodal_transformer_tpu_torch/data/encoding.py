"""Humdrum **kern / **bekern tokenizer.

Copy of ``omr_a2s_multimodal_transformer_tpu/data/encoding.py``, a
behavior-equivalent re-implementation of the reference tokenizer (its
``src/data/encoding.py:17-181``): cleans raw kern text into a
per-event/per-voice token grid, resolves ``*`` clef-change placeholders, and
linearizes the 2D score into a 1D token stream with ``<con>``/``<coc>``/``<cor>``
separators.

This is pure host-side Python (string processing); it runs once per sample in
the input pipeline, so there is nothing to put on the device here.
"""

from __future__ import annotations

import re
from typing import List, Optional

# Structural separator tokens used when linearizing the 2D score.
CON_TOKEN = "<con>"  # change-of-note (between notes of a chord)
COC_TOKEN = "<coc>"  # change-of-column (between voices of an event)
COR_TOKEN = "<cor>"  # change-of-row (between events)

ENCODING_OPTIONS = ["kern", "bekern"]

# Tokens containing any of these substrings are kept verbatim.
_KEEP_VERBATIM_SUBSTRINGS = ("clef", "*k[", "*M")

DOT_TOKEN = "DOT"  # replaces '.' (voice-sync placeholder)
_CLEF_PLACEHOLDER = "*"
_OPEN_SPINE = "*^"
_CLOSE_SPINE = "*v"

_NOTE_RE = re.compile(r"\d+[.]*[a-gA-G]+[n#-]*")
_GRACE_RE = re.compile(r"\d*[a-gA-G]+[n#-]*[q]+")
_MULTIREST_RE = re.compile(r"rr[0-9]+")


def clean_kern_token(token: str) -> Optional[str]:
    """Map one raw kern token to its cleaned form.

    Returns ``None`` when the token (and therefore its whole voice for this
    event) must be dropped: comments/interpretations, or tokens that fail to
    parse as a note/rest. Mirrors ``_cleanKernToken``
    (reference ``encoding.py:110-152``) including its failure modes: a regex
    miss is reported as ``None`` here instead of raising.
    """
    token = token.replace("·", "")  # bekern uses '·' as an infix separator

    if any(s in token for s in _KEEP_VERBATIM_SUBSTRINGS):
        return token  # clef / key signature / meter: keep verbatim
    if token == ".":
        return DOT_TOKEN
    stripped = token.strip()
    if stripped == _CLEF_PLACEHOLDER:
        return token  # clef change in *other* voices; resolved later
    if stripped in (_OPEN_SPINE, _CLOSE_SPINE):
        return token
    if token.startswith("*") or token.startswith("!"):
        return None  # interpretation / comment
    if token.startswith("s"):
        return "s"  # slur
    if "=" in token:
        return "="  # barline

    if "q" in token:  # grace note
        m = _GRACE_RE.search(token)
        return m.group(0) if m else None

    if "rr" in token:  # multi-measure rest
        m = _MULTIREST_RE.search(token)
        return m.group(0) if m else None
    if "r" in token:  # rest: keep duration prefix
        return token.split("r")[0] + "r"

    m = _NOTE_RE.search(token)
    if m is None:
        return None
    out = m.group(0)
    if "[" in token:
        out += "["  # tie open
    if "]" in token:
        out += "]"  # tie close
    return out


def _clean_voice(voice: str) -> Optional[str]:
    """Clean a voice field (space-separated chord tokens).

    The whole voice is dropped (``None``) if any chord token cleans to
    ``None`` — same all-or-nothing behavior as the reference's try/except
    around the join (``encoding.py:95-100``).
    """
    cleaned = []
    for sub in voice.split(" "):
        c = clean_kern_token(sub)
        if c is None:
            return None
        cleaned.append(c)
    return " ".join(cleaned)


def _first_clef_offset(column_history: List[str]) -> Optional[int]:
    """Offset of the first entry starting with ``*clef``, or None.

    The reference's ``max(np.where(...))[0]`` evaluates to the *first*
    matching index (``encoding.py:74``); we keep that semantics.
    """
    for off, entry in enumerate(column_history):
        if entry.startswith("*clef"):
            return off
    return None


def resolve_clef_placeholders(score: List[List[str]]) -> List[List[str]]:
    """Replace bare ``*`` placeholders with the clef they stand for.

    For each event row containing a voice equal to ``*`` (and no spine
    open/close in that row), walk upward to the first row where that voice
    column exists, then substitute the first ``*clef...`` entry seen in that
    column since; if none is found, fall back to the left-neighbor token on
    the same row. Mirrors ``_postprocessKernSequence``
    (reference ``encoding.py:47-81``), mutating in place so earlier
    substitutions are visible to later fallbacks.
    """
    for row_idx, row in enumerate(score):
        if _CLEF_PLACEHOLDER not in row or _OPEN_SPINE in row or _CLOSE_SPINE in row:
            continue
        for col in [c for c, v in enumerate(row) if v == _CLEF_PLACEHOLDER]:
            # Walk upward while the column exists; stop just below the first
            # row where it does not.
            ref = row_idx
            while ref >= 0 and len(score[ref]) >= col + 1:
                ref -= 1
            if ref >= 0:
                ref += 1
            # NOTE: when every row has this column the reference leaves the
            # cursor at -1, which through Python slice semantics yields an
            # empty history; we reproduce that (ref == -1 -> empty slice
            # unless row_idx is the last index).
            history = [r[col] for r in score[ref:row_idx]]
            off = _first_clef_offset(history)
            if off is not None:
                score[row_idx][col] = score[ref + off][col]
            else:
                score[row_idx][col] = score[row_idx][col - 1]
    return score


class KrnParser:
    """Kern/bekern tokenizer with the reference's public surface.

    Reference: its ``src/data/encoding.py:17-181``. ``encode``
    takes the raw text of a polyphonic kern file and returns the linearized
    token list used as the transcription target.
    """

    def __init__(self, encoding: str = "bekern"):
        if encoding not in ENCODING_OPTIONS:
            raise ValueError(f"encoding must be one of {ENCODING_OPTIONS}, got {encoding!r}")
        self.encoding = encoding
        self.header_word = "**kern" if encoding == "kern" else "**bekern"

    def clean(self, text: str) -> List[List[str]]:
        """Raw kern text -> cleaned [event][voice] grid with clefs resolved."""
        score: List[List[str]] = []
        for line in text.splitlines():
            voices = [v for v in (_clean_voice(f) for f in line.split("\t")) if v is not None]
            if voices:
                score.append(voices)
        return resolve_clef_placeholders(score)

    def encode(self, text: str) -> List[str]:
        """Raw kern text -> 1D token list with <con>/<coc>/<cor> separators."""
        grid = self.clean(text)
        out: List[str] = []
        for i, voices in enumerate(grid):
            for j, voice in enumerate(voices):
                notes = voice.split()
                for k, note in enumerate(notes):
                    out.append(note)
                    if k != len(notes) - 1:
                        out.append(CON_TOKEN)
                if j != len(voices) - 1:
                    out.append(COC_TOKEN)
            if i != len(grid) - 1:
                out.append(COR_TOKEN)
        return out


# Reference-compatible alias (the reference exposes the class as `krnParser`).
krnParser = KrnParser
