"""Decompose an audio model's SER into ambiguity-class mass vs model
deficit, on the port.

Port of ``tools/diagnose_audio_errors.py``. The 'tones' audio encoding is
lossy (``tools/oracle_audio_floor.py``: a floor of 13.5 SER exact, 20.7 at
STFT-bin resolution); this tool measures where a trained checkpoint's
errors above that floor live, by aligning predicted and true transcripts
line by line and classifying the token-error mass:

  audio_identical   the predicted line renders the same (f0, dur) tone
                    multiset as the truth (the tones map of
                    ``data/sources.py``: f0 = 110*2^(v + (rank+0.5*acc)/12)):
                    inaudible ambiguity-class errors no audio model avoids
  audio_bin_alias   identical only after quantizing f0 to the STFT bin grid
                    (22050/2048 Hz)
  duration_error    tone f0 multisets match but durations differ
  structure_error   a different tone count (rest-vs-play, chord-vs-single)
  pitch_error       the same structure, audibly different frequencies
  line_count        more/fewer lines than the truth (insertions/deletions
                    of whole events, barlines included)

``main`` greedy-decodes the split with the port's decode, the model's
parameters cast to bfloat16 as the JAX tool casts its params. Runs on
``cuda`` unless given ``--device cpu``:
  python -m omr_a2s_multimodal_transformer_tpu_torch.tools.diagnose_audio_errors \
      --workdir runs/grid_r05_tones --ckpt runs/grid_r05_tones/weights/audio/best [--split test]
"""

from __future__ import annotations

import argparse
import difflib
import json
import os
from collections import Counter

import torch

from omr_a2s_multimodal_transformer_tpu_torch.tools.run_convergence import synth_cfg

_BIN_HZ = 22050.0 / 2048.0


def tones_f0(v: int, rank: int, acc: int) -> float:
    return 110.0 * (2.0 ** (v + (rank + 0.5 * acc) / 12.0))


def parse_token(tok: str, pitches):
    """'16b#' -> (dur, rank, acc) or None for non-note tokens."""
    i = 0
    while i < len(tok) and tok[i].isdigit():
        i += 1
    if i == 0:
        return None
    dur, rest = tok[:i], tok[i:]
    acc = 0
    if rest.endswith("#"):
        acc, rest = 1, rest[:-1]
    elif rest.endswith("-"):
        acc, rest = -1, rest[:-1]
    if rest not in pitches:
        return None
    return int(dur), pitches.index(rest), acc


def lines_from_tokens(toks, pitches):
    """Token stream -> list of per-line tone descriptors.

    Each line is a tuple (line_string, tones) where tones is the multiset
    of (voice, dur, rank, acc) the line renders; barlines/interpretations
    yield tones=() and are classified separately by string equality.
    """
    out, cur, voice = [], [], 0
    notes = []
    for t in toks:
        if t == "<cor>":
            out.append((" ".join(cur), tuple(sorted(notes))))
            cur, voice, notes = [], 0, []
        elif t == "<coc>":
            voice = 1
            cur.append(t)
        elif t == "<con>":
            cur.append(t)
        else:
            cur.append(t)
            p = parse_token(t, pitches)
            if p is not None:
                dur, rank, acc = p
                notes.append((voice, dur, rank, acc))
    if cur:
        out.append((" ".join(cur), tuple(sorted(notes))))
    return out


def tone_multiset(notes, bin_quantized=False):
    """(voice,dur,rank,acc) multiset -> audible (f0_key, dur) multiset."""
    out = []
    for v, dur, rank, acc in notes:
        f0 = tones_f0(v, rank, acc)
        key = round(f0 / _BIN_HZ) if bin_quantized else round(f0, 6)
        out.append((key, dur))
    return tuple(sorted(out))


def classify_line_pair(g_line, p_line):
    g_str, g_notes = g_line
    p_str, p_notes = p_line
    if g_str == p_str:
        return "equal"
    if not g_notes and not p_notes:
        return "line_count"  # differing barline/interp lines
    if tone_multiset(g_notes) == tone_multiset(p_notes):
        return "audio_identical"
    if tone_multiset(g_notes, True) == tone_multiset(p_notes, True):
        return "audio_bin_alias"
    if len(g_notes) != len(p_notes):
        return "structure_error"
    g_f0 = tuple(sorted(k for k, _ in tone_multiset(g_notes)))
    p_f0 = tuple(sorted(k for k, _ in tone_multiset(p_notes)))
    if g_f0 == p_f0:
        return "duration_error"
    g_f0b = tuple(sorted(k for k, _ in tone_multiset(g_notes, True)))
    p_f0b = tuple(sorted(k for k, _ in tone_multiset(p_notes, True)))
    if g_f0b == p_f0b:
        return "duration_error"
    return "pitch_error"


def line_token_cost(g_line, p_line):
    """Token-level edit cost between two lines (the SER mass at stake)."""
    g, p = g_line[0].split(" "), p_line[0].split(" ")
    sm = difflib.SequenceMatcher(a=g, b=p, autojunk=False)
    cost = 0
    for tag, i1, i2, j1, j2 in sm.get_opcodes():
        if tag != "equal":
            cost += max(i2 - i1, j2 - j1)
    return cost


def decompose(pairs, pitches):
    """pairs: [(gt_tokens, pred_tokens)] -> error-mass per class."""
    mass = Counter()
    per_sample = []
    for g_toks, p_toks in pairs:
        g_lines = lines_from_tokens(g_toks, pitches)
        p_lines = lines_from_tokens(p_toks, pitches)
        sm = difflib.SequenceMatcher(
            a=[ln[0] for ln in g_lines], b=[ln[0] for ln in p_lines], autojunk=False)
        s_mass = Counter()
        for tag, i1, i2, j1, j2 in sm.get_opcodes():
            if tag == "equal":
                continue
            if tag == "replace":
                for gi, pi in zip(range(i1, i2), range(j1, j2)):
                    cls = classify_line_pair(g_lines[gi], p_lines[pi])
                    s_mass[cls] += line_token_cost(g_lines[gi], p_lines[pi])
                extra = (i2 - i1) - (j2 - j1)
                rng = (range(j1 + (i2 - i1), j2) if extra < 0
                       else range(i1 + (j2 - j1), i2))
                src = p_lines if extra < 0 else g_lines
                for k in rng:
                    s_mass["line_count"] += len(src[k][0].split(" "))
            else:  # insert / delete of whole lines
                src, rng = (g_lines, range(i1, i2)) if tag == "delete" else (p_lines, range(j1, j2))
                for k in rng:
                    s_mass["line_count"] += len(src[k][0].split(" "))
        mass.update(s_mass)
        per_sample.append(dict(s_mass))
    return mass, per_sample


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default="runs/grid_r05_tones")
    ap.add_argument("--ckpt", default="runs/grid_r05_tones/weights/audio/best")
    ap.add_argument("--train_n", type=int, default=1024)
    ap.add_argument("--eval_n", type=int, default=128)
    ap.add_argument("--n_measures", type=int, default=30)
    ap.add_argument("--measures_range", nargs=2, type=int, default=[2, 30])
    ap.add_argument("--render_style", default="grand")
    ap.add_argument("--audio_style", default="tones")
    ap.add_argument("--split", default="test", choices=["val", "test"])
    ap.add_argument("--n_batches", type=int, default=16)
    ap.add_argument("--out", default=os.path.join("runs", "diagnose_audio_errors", "report.json"))
    ap.add_argument("--smoke", action="store_true", help="the smoke corpus's tiny shapes (run_convergence.synth_cfg)")
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)

    from omr_a2s_multimodal_transformer_tpu_torch.cli import common
    from omr_a2s_multimodal_transformer_tpu_torch.cli import test as test_cli
    from omr_a2s_multimodal_transformer_tpu_torch.data import sources
    from omr_a2s_multimodal_transformer_tpu_torch.tools.diagnose_errors import cast_params, decode_batches
    from omr_a2s_multimodal_transformer_tpu_torch.utils.metrics import compute_ed_metrics

    cache_root = os.path.join(args.workdir, "grandstaff_cache")
    a = test_cli.build_parser().parse_args([
        "--ds_name", "synthetic",
        "--synthetic_config", synth_cfg(args.train_n, args.eval_n, args.smoke,
                                        args.n_measures, args.render_style,
                                        measures_range=args.measures_range,
                                        audio_style=args.audio_style),
        "--krn_encoding", "kern",
        "--use_distorted_images",
        "--cache_root", cache_root,
        "--batch_size", "8", "--eval_batch_size", "8",
        "--num_workers", "8",
        "--input_modality", "audio",
        "--checkpoint_path", args.ckpt,
        "--device", args.device,
    ])
    common.init_cli(a)
    dm = common.make_datamodule(a, "audio")
    dm.setup("fit" if args.split == "val" else "test")
    model, hp, _ = common.build_from_checkpoint(args.ckpt, device=a.device)
    vocab = dm.get_vocab()
    cast_params(model, torch.bfloat16)

    loader = dm.val_dataloader() if args.split == "val" else dm.test_dataloader()
    pairs = decode_batches(model, vocab, loader, args.n_batches)

    m = compute_ed_metrics([g for g, _ in pairs], [p for _, p in pairs])
    mass, _ = decompose(pairs, sources._PITCHES)
    total_err = sum(mass.values())
    total_gt = sum(len(g) for g, _ in pairs)
    report = {
        "config": vars(args),
        "n_samples": len(pairs),
        "sym_er": round(float(m["sym-er"]), 3),
        "seq_er": round(float(m["seq-er"]), 3),
        "error_mass_tokens": dict(mass),
        "error_mass_pct_of_gt": {k: round(100.0 * v / total_gt, 2)
                                 for k, v in mass.items()},
        "share_of_errors_pct": {k: round(100.0 * v / max(1, total_err), 1)
                                for k, v in mass.items()},
        "ambiguity_class_pct_of_gt": round(
            100.0 * (mass["audio_identical"] + mass["audio_bin_alias"]) / total_gt, 2),
        "model_deficit_pct_of_gt": round(
            100.0 * (mass["duration_error"] + mass["structure_error"]
                     + mass["pitch_error"] + mass["line_count"]) / total_gt, 2),
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: v for k, v in report.items() if k != "config"}, indent=1))
    print("->", args.out)
    return report


if __name__ == "__main__":
    main()
