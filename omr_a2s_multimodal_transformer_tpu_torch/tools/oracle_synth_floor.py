"""Information floor of the synthetic image corpus, measured by inverting
the renderer, on the port's corpus.

Port of ``tools/oracle_synth_floor.py``, reading the port's
``data/sources.py``, ``data/encoding.py`` and ``utils/metrics.py`` (host
only, no device).

The convergence runs plateau at val Sym-ER ~47-48 regardless of train-set
size (256 vs 1024 samples at equal step counts match to 0.1 SER), which
raises the question: is the plateau a *corpus* limit (the rendering does
not preserve the tokens) or a *model/optimization* limit?

This tool answers it without training anything: a programmatic ORACLE
decoder inverts ``data/sources.py:render_score_image`` (barline grid ->
event columns -> per-voice blob runs -> (duration, pitch-rank, accidental)
-> kern text) and scores its reconstruction with the exact eval
tokenization + metric (``KrnParser.encode`` + ``compute_ed_metrics``).
The oracle SER is an upper bound on the corpus' information floor; the
gap between it and a trained model's plateau is the model/optimization
deficit, NOT a data problem.

Known irreducible ambiguities (counted by the oracle, by design):
- chord note ORDER inside a voice is the generator's RNG draw order, which
  the pixels cannot encode (the oracle emits blobs top-down);
- two chord notes at the same pitch rank overlap; the smaller blob (longer
  duration) can be hidden entirely.

Usage: python -m omr_a2s_multimodal_transformer_tpu_torch.tools.oracle_synth_floor [--n 64] [--seed 1]
       [--measures 30] [--style blob|grand]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from omr_a2s_multimodal_transformer_tpu_torch.data import sources
from omr_a2s_multimodal_transformer_tpu_torch.data.encoding import KrnParser
from omr_a2s_multimodal_transformer_tpu_torch.utils.metrics import compute_ed_metrics

_DUR_OF_R = {4: "2", 3: "4", 2: "8", 1: "16"}


def _blob_runs(col_black: np.ndarray):
    """Row indices with black -> list of (start, stop) consecutive runs."""
    rows = np.flatnonzero(col_black)
    if rows.size == 0:
        return []
    runs, s, p = [], int(rows[0]), int(rows[0])
    for r in rows[1:]:
        r = int(r)
        if r == p + 1:
            p = r
        else:
            runs.append((s, p + 1))
            s = p = r
    runs.append((s, p + 1))
    return runs


def decode_image(img: np.ndarray, n_pitches: int) -> str:
    """Inverse of render_score_image for the synthetic corpus geometry
    (2 voice bands, 4-note measures separated by full-height barlines)."""
    h, w = img.shape
    black = img < 100  # staff lines are rendered at 200: excluded
    # Barlines: x columns black over the full height.
    full = black.all(axis=0)
    # group consecutive columns into bars
    bars = _blob_runs(full)
    if not bars:
        return ""
    n_measures = len(bars)
    n_events = 5 * n_measures  # "=m" + 4 note rows per measure
    dx = max(1, w // n_events)
    band_h = h // 2
    parser_lines = ["**kern\t**kern", "*clefF4\t*clefG2", "*M4/4\t*M4/4"]
    for m in range(n_measures):
        parser_lines.append(f"={m + 1}\t={m + 1}")
        for k in range(4):
            e = 5 * m + 1 + k
            x = min(e * dx + dx // 2, w - 2)
            cols = []
            for v in range(2):
                top = h - (v + 1) * band_h
                strip = black[:, max(0, x - 4): x + 5]
                band = strip[top: top + band_h + 3]  # +3: flat tick can sit below
                prof = band.any(axis=1)
                runs = _blob_runs(prof)
                # classify: blobs are height >= 2 runs; 1-px runs are ticks
                blobs = [(s, t) for (s, t) in runs if t - s >= 2]
                ticks = {s for (s, t) in runs if t - s == 1}
                notes = []
                for (s, t) in blobs:
                    r = max(1, (t - s) // 2)
                    cy = top + (s + t) / 2.0
                    frac = (cy - top) / band_h
                    rank = round((0.85 - frac) * (n_pitches - 1) / 0.7)
                    rank = min(max(rank, 0), n_pitches - 1)
                    acc = ""
                    if (s - 2) in ticks:
                        acc = "#"
                    elif t + 1 in ticks:
                        acc = "-"
                    notes.append(f"{_DUR_OF_R.get(min(r, 4), '8')}{sources._PITCHES[rank]}{acc}")
                cols.append(" ".join(notes) if notes else ".")
            parser_lines.append(f"{cols[0]}\t{cols[1]}")
    parser_lines.append("*-\t*-")
    return "\n".join(parser_lines) + "\n"


def _frac_black(region: np.ndarray) -> float:
    return float(region.mean()) if region.size else 0.0


def decode_image_grand(img: np.ndarray, n_pitches: int) -> str:
    """Inverse of sources._render_grand by geometry-aware pixel probing.

    The renderer's layout is fully determined by (h, w, n_events), so instead
    of connected-component analysis (fragile when flags/stems of dense events
    touch) the oracle probes the EXACT boxes a glyph would occupy: a head
    exists where the 2r x 2r box border is ~all black; duration from
    interior (hollow=2) / stem / flag probes; accidental from the left-bar
    probes. Irreducible ambiguities (chord RNG draw order) remain counted,
    as in the blob oracle."""
    h, w = img.shape
    black = img < 100
    full = black.all(axis=0)
    bars = _blob_runs(full)
    if not bars:
        return ""
    n_measures = len(bars)
    n_events = 5 * n_measures
    band_h, dx, r = sources.grand_geometry(h, w, n_events)
    stem = 2 * r
    parser_lines = ["**kern\t**kern", "*clefF4\t*clefG2", "*M4/4\t*M4/4"]
    for m in range(n_measures):
        parser_lines.append(f"={m + 1}\t={m + 1}")
        for k in range(4):
            e = 5 * m + 1 + k
            x = min(e * dx + dx // 2, w - 2)
            cols = []
            for v in range(2):
                top = h - (v + 1) * band_h
                notes = []  # (cy, token) -> emitted top-down like the renderer's component order
                for cx in (x, x + 2 * r + 4):
                    for rank in range(n_pitches):
                        frac = 0.85 - 0.7 * rank / max(1, n_pitches - 1)
                        cy = top + int(band_h * frac)
                        y0, y1, x0, x1 = cy - r, cy + r, cx - r, cx + r
                        if y0 < 0 or y1 > h or x0 < 0 or x1 > w:
                            continue
                        box = black[y0:y1, x0:x1]
                        border = np.concatenate([box[0], box[-1], box[:, 0], box[:, -1]])
                        if _frac_black(border) < 0.9:
                            continue
                        hollow = _frac_black(black[cy - 1:cy + 1, cx - 1:cx + 1]) < 0.5
                        if hollow:
                            dur = "2"
                        elif _frac_black(black[max(0, y0 - stem):y0, x1 - 2:x1]) >= 0.6:
                            flag = _frac_black(
                                black[max(0, y0 - stem):max(0, y0 - stem + 3), x1:min(w, x1 + r)]
                            ) >= 0.6
                            dur = "16" if flag else "8"
                        else:
                            dur = "4"
                        acc = ""
                        if x0 - 4 >= 0:
                            if _frac_black(black[max(0, y0):cy, x0 - 4:x0 - 2]) >= 0.6:
                                acc = "#"
                            elif _frac_black(black[cy:y1, x0 - 4:x0 - 2]) >= 0.6:
                                acc = "-"
                        notes.append((cy, f"{dur}{sources._PITCHES[rank]}{acc}"))
                notes.sort(key=lambda t: t[0])  # top-down
                cols.append(" ".join(tok for _, tok in notes) if notes else ".")
            parser_lines.append(f"{cols[0]}\t{cols[1]}")
    parser_lines.append("*-\t*-")
    return "\n".join(parser_lines) + "\n"


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--seed", type=int, default=1, help="1 = the val split seed convention")
    p.add_argument("--measures", type=int, default=30)
    p.add_argument("--h_range", type=int, nargs=2, default=[355, 362])
    p.add_argument("--w_range", type=int, nargs=2, default=[4300, 4413])
    p.add_argument("--style", default="blob", choices=["blob", "grand"],
                   help="render style to invert (sources.render_score_image)")
    args = p.parse_args(argv)

    src = sources.SyntheticSource(
        n=args.n, seed=args.seed, n_measures=args.measures,
        img_height_range=tuple(args.h_range), img_width_range=tuple(args.w_range),
        encoding="kern", render_style=args.style,
    )
    parser = KrnParser("kern")
    y_true, y_pred = [], []
    for i in range(args.n):
        ex = src[i]
        img = np.asarray(ex["image"])
        decode = decode_image_grand if args.style == "grand" else decode_image
        rec = decode(img, n_pitches=len(sources._PITCHES))
        y_true.append(parser.encode(ex["transcript"]))
        y_pred.append(parser.encode(rec))
    m = compute_ed_metrics(y_true, y_pred)
    out = {"n": args.n, "seed": args.seed, "n_measures": args.measures, "style": args.style,
           "oracle_sym_er": round(float(m["sym-er"]), 3),
           "oracle_seq_er": round(float(m["seq-er"]), 3)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
