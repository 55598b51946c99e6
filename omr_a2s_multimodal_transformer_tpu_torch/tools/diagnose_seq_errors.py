"""Seq-ER diagnostic of a predictions file: are the residual errors of a
system systematic or uniform residue?

Port of ``tools/diagnose_seq_errors.py``. Reads a predictions .jsonl (the
port's cli.test ``--save_preds``: one {"y_true": [...], "y_pred": [...]}
a sample) and reports, over the aligned token edits of every sample:

  per_sample      error-count distribution (how many sequences are 1-2
                  edits from perfect: the seq-er story at sym-er << 1%)
  position_decile where in the sequence errors fall (deciles of relative
                  position; uniform residue is flat, a pad-boundary or
                  length bug spikes the last decile)
  near_barline    fraction of errors within +-window tokens of a barline
                  '=' vs the barline neighbourhood's share of all tokens
  token_class     edit mass per token class (note, rest, separator
                  <co*>, barline, interp)

Host only (no device):
  python -m omr_a2s_multimodal_transformer_tpu_torch.tools.diagnose_seq_errors --preds runs/.../preds.jsonl \
      [--out runs/diagnose_seq_errors/report.json]
"""

from __future__ import annotations

import argparse
import difflib
import json
import os
from collections import Counter


def token_class(t: str) -> str:
    if t == "=":
        return "barline"
    if t in ("<coc>", "<cor>", "<con>"):
        return "separator"
    if t == "DOT":
        return "rest"
    if t and t[0].isdigit():
        return "note"
    return "interp"


def seq_error_report(rows, window: int = 2) -> dict:
    """The report's statistics over ``rows`` ({"y_true", "y_pred"} token lists)."""
    per_sample = Counter()
    decile = Counter()
    cls_mass = Counter()
    near_bar = bar_zone_tokens = total_tokens = total_err = 0

    for r in rows:
        g, p = r["y_true"], r["y_pred"]
        bar_pos = {i for i, t in enumerate(g) if t == "="}
        zone = set()
        for b in bar_pos:
            zone.update(range(max(0, b - window), min(len(g), b + window + 1)))
        bar_zone_tokens += len(zone)
        total_tokens += len(g)

        sm = difflib.SequenceMatcher(a=g, b=p, autojunk=False)
        n_err = 0
        for tag, i1, i2, j1, j2 in sm.get_opcodes():
            if tag == "equal":
                continue
            n = max(i2 - i1, j2 - j1)
            n_err += n
            for k in range(i1, max(i2, i1 + 1)):
                ki = min(k, len(g) - 1)
                decile[min(9, int(10 * ki / max(1, len(g))))] += 1
                cls_mass[token_class(g[ki])] += 1
                if ki in zone:
                    near_bar += 1
        total_err += n_err
        per_sample[min(n_err, 10)] += 1  # bucket 10 = ">=10"

    n = len(rows)
    return {
        "n_samples": n,
        "total_gt_tokens": total_tokens,
        "total_error_tokens": total_err,
        "sym_er_pct_approx": round(100.0 * total_err / max(1, total_tokens), 3),
        "seq_er_pct": round(100.0 * sum(v for k, v in per_sample.items() if k > 0) / max(1, n), 1),
        "per_sample_error_hist": {str(k): v for k, v in sorted(per_sample.items())},
        "samples_within_2_edits_pct": round(
            100.0 * sum(v for k, v in per_sample.items() if k <= 2) / max(1, n), 1),
        "position_decile_hist": {str(k): v for k, v in sorted(decile.items())},
        "near_barline_err_pct": round(100.0 * near_bar / max(1, total_err), 1),
        "barline_zone_token_pct": round(100.0 * bar_zone_tokens / max(1, total_tokens), 1),
        "token_class_mass": dict(cls_mass),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preds", required=True)
    ap.add_argument("--out", default=os.path.join("runs", "diagnose_seq_errors", "report.json"))
    ap.add_argument("--window", type=int, default=2, help="barline neighborhood")
    args = ap.parse_args(argv)

    with open(args.preds) as f:
        rows = [json.loads(ln) for ln in f if ln.strip()]
    report = {"preds": args.preds, **seq_error_report(rows, args.window)}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
