"""Summarize a reference-scale streaming-ingest run into one report:
per-epoch samples/s of a training run without the device cache against
the device-cache path's rate, plus the loader-only throughput of
``bench_ingest`` if its lines are given.

Port of ``tools/summarize_ingest.py``: it reads the port's run directory
(``metrics.jsonl`` that ``cli.train`` and the ``Trainer`` write: an epoch's
``samples_per_sec``, ``time_data_total_s``, ``time_step_total_s``) and a
log of ``bench_ingest``'s JSON lines, and writes JAX's report. Host only
(no device):

    python -m omr_a2s_multimodal_transformer_tpu_torch.tools.summarize_ingest [--run_dir runs/ingest_25k/runs] \\
        [--ingest_log runs/bench_ingest_25k.log] [--out runs/ingest_25k.json]
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run_dir", default="runs/ingest_25k/runs")
    ap.add_argument("--ingest_log", default="runs/bench_ingest_25k.log")
    ap.add_argument("--device_cache_samples_per_sec", type=float, default=36.0,
                    help="the steady-state train samples/s of the same recipe with the corpus on the device "
                         "(JAX's default, its TPU's grid image legs: give the card's)")
    ap.add_argument("--out", default="runs/ingest_25k.json")
    args = ap.parse_args(argv)

    rows = []
    mpath = os.path.join(args.run_dir, "metrics.jsonl")
    if os.path.exists(mpath):
        rows = [json.loads(ln) for ln in open(mpath) if ln.strip()]
    epochs = [r for r in rows if "samples_per_sec" in r]
    loader_lines = []
    if os.path.exists(args.ingest_log):
        for ln in open(args.ingest_log):
            ln = ln.strip()
            if ln.startswith("{"):
                try:
                    loader_lines.append(json.loads(ln))
                except ValueError:
                    pass

    report = {
        "corpus": {"train_n": 25691, "geometry": "production varied 2-30 measures, "
                   "grand render, b8 image 361x4416 max", "device_cache": False,
                   "loader": "the port's worker loader (grain), 8 worker processes"},
        "train_epochs": [
            {k: round(float(r[k]), 4) if isinstance(r[k], (int, float)) else r[k]
             for k in ("epoch", "train_loss", "samples_per_sec",
                       "time_data_total_s", "time_step_total_s") if k in r}
            for r in epochs
        ],
        "streaming_samples_per_sec": (round(float(epochs[-1]["samples_per_sec"]), 2)
                                      if epochs else None),
        "device_cache_samples_per_sec": args.device_cache_samples_per_sec,
        "loader_only": loader_lines,
    }
    if epochs:
        s = report["streaming_samples_per_sec"]
        report["streaming_vs_device_cache_pct"] = round(
            100.0 * s / args.device_cache_samples_per_sec, 1)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: v for k, v in report.items() if k != "train_epochs"}, indent=1))
    print("->", args.out)
    return report


if __name__ == "__main__":
    main()
