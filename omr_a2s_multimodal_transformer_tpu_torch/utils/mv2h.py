"""MV2H metric pipeline (optional; requires music21 + pyMV2H).

Port of ``omr_a2s_multimodal_transformer_tpu/utils/mv2h.py``. Parity with
the reference (metrics.py:94-338): token sequence -> kern file
(``seq2kern``) -> music21 MIDI -> pyMV2H txt -> mv2h score, with the
polyphonic path and a per-voice monophonic fallback. Exception handling is
broad by design, matching the reference (a failed sample contributes 0).

``seq2kern`` is dependency-free and unit-tested; the rest is host-side glue
around external tools.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Dict, List, Sequence

from omr_a2s_multimodal_transformer_tpu_torch.data.encoding import COC_TOKEN, CON_TOKEN, COR_TOKEN, DOT_TOKEN


def seq2kern_lines(sequence: Sequence[str]) -> List[str]:
    """Linearized token sequence -> kern file lines (reference
    metrics.py:243-279). Column count inferred from the first <cor>."""
    first_cor = next((i for i, t in enumerate(sequence) if t == COR_TOKEN), len(sequence))
    n_cols = (first_cor + 1) // 2

    lines = ["\t".join(["**kern"] * n_cols)]
    line: List[str] = []
    pending_chord = False
    for token in sequence:
        if token == COR_TOKEN:
            if line:
                if len(line) < n_cols:
                    line.extend(["."] * (n_cols - len(line)))
                lines.append("\t".join(line))
            line = []
        elif token == COC_TOKEN:
            continue
        elif token == CON_TOKEN:
            pending_chord = True
        elif token == DOT_TOKEN:
            line.append(".")
        else:
            if pending_chord:
                if line:
                    line[-1] = line[-1] + " " + token
                else:
                    line.append(token)
                pending_chord = False
            else:
                line.append(token)
    return lines


def seq2kern(sequence: Sequence[str], path: str) -> None:
    with open(path, "w") as f:
        f.write("\n".join(seq2kern_lines(sequence)) + "\n")


def _require_deps():
    try:
        from music21 import converter  # noqa: F401
        from pyMV2H.metrics.mv2h import mv2h  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "MV2H evaluation requires `music21` and `pyMV2H` "
            "(pip install music21 pyMV2H). SER/seq-ER work without them."
        ) from e


def compute_mv2h_metrics(y_true: Sequence[List[str]], y_pred: Sequence[List[str]]) -> Dict[str, float]:
    _require_deps()
    from music21 import converter as converterm21
    from pyMV2H.converter.midi_converter import MidiConverter
    from pyMV2H.metrics.mv2h import mv2h
    from pyMV2H.utils.music import Music
    from pyMV2H.utils.mv2h import MV2H

    def krn2midi(krn_path: str) -> str:
        # Spine open/close tokens break music21's kern importer.
        with open(krn_path) as f:
            lines = [ln for ln in f.readlines() if ln not in ("*^\n", "*v\n")]
        with open(krn_path, "w") as f:
            f.writelines(lines)
        out = converterm21.parse(krn_path).write("midi")
        midi_path = krn_path + ".mid"
        shutil.copyfile(out, midi_path)
        return midi_path

    def midi2txt(midi_path: str) -> str:
        txt_path = midi_path.replace(".mid", ".txt")
        MidiConverter(file=midi_path, output=txt_path).convert_file()
        with open(txt_path) as f:
            content = [u.replace(".0", "") for u in f.readlines()]
        with open(txt_path, "w") as f:
            f.writelines(content)
        return txt_path

    def score_pair(gt_krn: str, pred_krn: str):
        r_txt = midi2txt(krn2midi(gt_krn))
        p_txt = midi2txt(krn2midi(pred_krn))
        return mv2h(Music.from_file(r_txt), Music.from_file(p_txt))

    fields = ("multi_pitch", "voice", "meter", "harmony", "note_value")

    def write_voice(src: str, dst: str, voice: int) -> bool:
        """Extract one tab-separated voice column into its own kern file
        (reference metrics.py:163-180). False when the column is absent."""
        try:
            with open(src) as f:
                col = [ln.split("\t")[voice].strip() for ln in f]
        except IndexError:
            return False
        with open(dst, "w") as f:
            f.write("\n".join(col) + "\n")
        return True

    def score_monophonic(gt_krn: str, pred_krn: str, tmp: str):
        """Per-voice fallback when the polyphonic prediction fails to parse
        (reference metrics.py:182-239): average MV2H over aligned voices;
        a voice present on only one side contributes 0."""
        sums = dict.fromkeys(fields, 0.0)
        n_voices = 0
        while True:
            gv = os.path.join(tmp, "gt_voice.krn")
            pv = os.path.join(tmp, "pred_voice.krn")
            has_g = write_voice(gt_krn, gv, n_voices)
            has_p = write_voice(pred_krn, pv, n_voices)
            if not has_g and not has_p:
                break
            if has_g and has_p:
                try:
                    res = score_pair(gv, pv)
                    for k in fields:
                        sums[k] += getattr(res, k)
                except Exception:
                    pass
            n_voices += 1
        if n_voices:
            for k in fields:
                sums[k] /= n_voices
        return sums

    totals = dict.fromkeys(fields, 0.0)
    with tempfile.TemporaryDirectory() as tmp:
        for t, h in zip(y_true, y_pred):
            gt_path = os.path.join(tmp, "gt.krn")
            pred_path = os.path.join(tmp, "pred.krn")
            try:
                seq2kern(t, gt_path)
                seq2kern(h, pred_path)
                try:
                    converterm21.parse(pred_path).write("midi")
                    polyphonic_ok = True
                except Exception:
                    polyphonic_ok = False
                if polyphonic_ok:
                    seq2kern(t, gt_path)  # krn2midi consumes/rewrites files
                    seq2kern(h, pred_path)
                    res = score_pair(gt_path, pred_path)
                    vals = {k: getattr(res, k) for k in fields}
                else:
                    vals = score_monophonic(gt_path, pred_path, tmp)
                for k in fields:
                    totals[k] += vals[k]
            except Exception:
                pass  # contributes 0, like the reference (metrics.py:312-314)

    n = max(len(y_true), 1)
    avg = {k.replace("_", "-") if k == "multi_pitch" else k: v / n for k, v in totals.items()}
    avg["mv2h"] = sum(totals.values()) / (5.0 * n)
    return avg
