"""Information floor of the synthetic AUDIO corpus, measured by Bayes-
optimal decoding of the encoding's exact collision structure, on the
port's corpus.

Port of ``tools/oracle_audio_floor.py``, reading the port's
``data/sources.py``, ``data/encoding.py`` and ``utils/metrics.py`` (host
only, no device).

The audio-only convergence runs on the default 'tones' encoding plateau at
test SER ~45 (STATUS.md round-4 grid) while the image side reaches the
corpus floor — raising the same question the image oracle
(tools/oracle_synth_floor.py) answered: is the audio plateau a *corpus*
limit or a *model* limit?

This tool answers it without training OR rendering: the idealized decoder
is granted PERFECT frequency and duration-class estimation (noiseless pure
sines make both near-exact for any sufficiently good estimator), so the
only remaining errors are EXACT collisions of the note->tone map
(``data/sources.py:render_score_audio``):

- 'tones': f0 = 110*2^(v + (rank + 0.5*acc)/12) collides for
  (rank, acc=+1) == (rank+1, acc=-1) (the quarter-tone grid), for voice
  pairs an octave apart (the 17-rank span overlaps voices by 5 ranks,
  compounded by the quarter-tone grid), and chord-note ORDER inside the
  right voice is inaudible (both orders render identical waves). The
  decoder enumerates every (structure, note-assignment) consistent with
  the observed (f0, dur) multiset, weighs it by the generator's priors
  (left rests 20%, right chords 30%, note fields uniform —
  sources.synthetic_kern), and picks the max-posterior transcript.
- 'bands': the map is injective per simultaneity group
  (sources.bands_tone_bin; roundtrip-proven in tests/test_audio_bands.py),
  so the same machinery must return floor 0.

The reported SER is a LOWER bound on what any model can reach on this
corpus from audio alone; the gap between it and a trained model's plateau
is the model/optimization deficit, NOT a data problem.

Usage: python -m omr_a2s_multimodal_transformer_tpu_torch.tools.oracle_audio_floor [--n 128] [--seed 3]
       [--measures 30] [--measures_range 2 30] [--style tones|bands]
"""

from __future__ import annotations

import argparse
import itertools
import json
from collections import defaultdict

from omr_a2s_multimodal_transformer_tpu_torch.data import sources
from omr_a2s_multimodal_transformer_tpu_torch.data.encoding import KrnParser
from omr_a2s_multimodal_transformer_tpu_torch.utils.metrics import compute_ed_metrics

_N_RANKS = len(sources._PITCHES)

# generator priors (sources.synthetic_kern)
P_LEFT_PLAY, P_LEFT_REST = 0.8, 0.2
P_CHORD, P_SINGLE = 0.3, 0.7


_BIN_HZ = 22050.0 / 2048.0  # ops/stft.py SAMPLE_RATE / N_FFT


def _f0_key(v: int, ci: int, rank: int, acc: int, style: str,
            bin_quantized: bool = False) -> float:
    if style == "bands":
        return float(sources.bands_tone_bin(v, ci, rank, acc))
    f0 = 110.0 * (2.0 ** (v + (rank + 0.5 * acc) / 12.0))
    if bin_quantized:
        # what a per-bin argmax reader can distinguish (sub-bin peak
        # interpolation is information-theoretically available from the
        # magnitude STFT of isolated noiseless tones, so the exact-f0 floor
        # is the true one; this variant upper-brackets the practical floor
        # for a model that only resolves bin indices)
        return float(round(f0 / _BIN_HZ))
    return round(f0, 6)


def _candidate_maps(style: str, bin_quantized: bool = False):
    """f0-key -> [(rank, acc)] per structural slot (left, right1, right2)."""
    maps = [defaultdict(list), defaultdict(list), defaultdict(list)]
    for slot, (v, ci) in enumerate(((0, 0), (1, 0), (1, 1))):
        for rank in range(_N_RANKS):
            for acc in (-1, 0, 1):
                maps[slot][_f0_key(v, ci, rank, acc, style, bin_quantized)].append((rank, acc))
    return maps


def _tok(dur: int, rank: int, acc: int) -> str:
    return f"{dur}{sources._PITCHES[rank]}{'#' if acc == 1 else '-' if acc == -1 else ''}"


def bayes_decode_slot(observed, maps):
    """observed: list of (f0_key, dur) tones this slot (truth-emitted).

    Returns the max-posterior "left\tright" line. Enumerates every
    structural assignment of observed tones to (left, right-note-1,
    right-note-2) and every (rank, acc) candidate per assigned slot,
    accumulating generator-prior mass per resulting token line.
    """
    k = len(observed)
    scores = defaultdict(float)

    def add(left_tone, right_tones, p_struct):
        # candidate sets per assigned structural slot
        cand_sets = []
        if left_tone is not None:
            cand_sets.append([(0, left_tone, c) for c in maps[0][left_tone[0]]])
        for j, t in enumerate(right_tones):
            cand_sets.append([(1 + j, t, c) for c in maps[1 + j][t[0]]])
        if any(len(s) == 0 for s in cand_sets):
            return  # assignment inconsistent with the encoding
        n_opts = 1
        for s in cand_sets:
            n_opts *= len(s)
        for combo in itertools.product(*cand_sets):
            left_tok = "."
            right_toks = [None, None]
            for slot, (f0, dur), (rank, acc) in combo:
                if slot == 0:
                    left_tok = _tok(dur, rank, acc)
                else:
                    right_toks[slot - 1] = _tok(dur, rank, acc)
            right = " ".join(t for t in right_toks if t is not None)
            # uniform note-field prior is constant given k; spread the
            # structural mass evenly over the candidate combos
            scores[f"{left_tok}\t{right}"] += p_struct / n_opts

    idx = list(range(k))
    if k == 1:
        add(None, [observed[0]], P_LEFT_REST * P_SINGLE)
    elif k == 2:
        for i in idx:
            j = 1 - i
            add(observed[i], [observed[j]], P_LEFT_PLAY * P_SINGLE / 2)
        for order in ((0, 1), (1, 0)):
            add(None, [observed[order[0]], observed[order[1]]],
                P_LEFT_REST * P_CHORD / 2)
    elif k == 3:
        for i in idx:
            rest = [j for j in idx if j != i]
            for order in (rest, rest[::-1]):
                add(observed[i], [observed[order[0]], observed[order[1]]],
                    P_LEFT_PLAY * P_CHORD / 2)
    else:  # k == 0 cannot occur (right voice always plays)
        return ".\t."
    return max(scores.items(), key=lambda kv: kv[1])[0] if scores else ".\t."


def oracle_transcript(transcript: str, style: str, maps, bin_quantized: bool = False) -> str:
    """Bayes-decode every note slot of a truth transcript; bars/headers are
    trivially audible (the barline click) and copied."""
    lines = ["**kern\t**kern", "*clefF4\t*clefG2", "*M4/4\t*M4/4"]
    bar = 0
    for kind, payload in sources._parse_kern_events(transcript):
        if kind == "bar":
            bar += 1
            lines.append(f"={bar}\t={bar}")
            continue
        observed = []
        for v, notes in enumerate(payload):
            for ci, (dur, rank, acc) in enumerate(notes):
                observed.append((_f0_key(v, ci, rank, acc, style, bin_quantized), dur))
        lines.append(bayes_decode_slot(observed, maps))
    lines.append("*-\t*-")
    return "\n".join(lines) + "\n"


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=128)
    p.add_argument("--seed", type=int, default=3, help="3 = the test split seed convention")
    p.add_argument("--measures", type=int, default=30)
    p.add_argument("--measures_range", nargs=2, type=int, default=None)
    p.add_argument("--style", default="tones", choices=["tones", "bands"])
    p.add_argument("--bin_quantized", action="store_true",
                   help="resolve frequency only to the STFT bin argmax "
                        "(upper bracket of the practical spectrogram floor)")
    args = p.parse_args(argv)

    src = sources.SyntheticSource(
        n=args.n, seed=args.seed, n_measures=args.measures,
        encoding="kern", n_measures_range=args.measures_range,
    )
    maps = _candidate_maps(args.style, args.bin_quantized)
    parser = KrnParser("kern")
    y_true, y_pred = [], []
    for i, truth in enumerate(src.transcripts()):
        y_true.append(parser.encode(truth))
        y_pred.append(parser.encode(
            oracle_transcript(truth, args.style, maps, args.bin_quantized)))
    m = compute_ed_metrics(y_true, y_pred)
    out = {"n": args.n, "seed": args.seed, "n_measures": args.measures,
           "measures_range": args.measures_range, "style": args.style,
           "bin_quantized": args.bin_quantized,
           "oracle_sym_er": round(float(m["sym-er"]), 3),
           "oracle_seq_er": round(float(m["seq-er"]), 3)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
