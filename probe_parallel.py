#!/usr/bin/env python3
"""Run chip_smoke.py's parallel phase and parallel path alone, on the cards present.

    python3 probe_parallel.py                    # one card: gloo ranks (dp 2 x 1, tp 1 x 2, 2 x 2)
    python3 probe_parallel.py --min-cards 4      # four cards: NCCL, a rank a card (dp 4 x 1, 2 x 2, tp 1 x 4)
    python3 probe_parallel.py --out-dir D        # results to D (default build/parallel_probe/)

The parallel path is the one part of the smoke that runs across cards, so
a call on four cards needs it and what it is held to, and nothing else:
this script builds the kernels, runs chip_smoke.py's parallel_phase (the
single-process reference steps, remat, K1/K2 at the shard shapes, the
cross-card check) and parallel_path (each rank's held step against the
reference and its dropout steps, then the CLIs under torchrun), with every
gate of the smoke, and prints each mesh's readings: the loss, the
gradients' relative L2 distance (the encoder's leaves and the rest apart)
and the share of parameter elements updated otherwise against the
single-process step, and a rank's host ms of its 2nd dropout step. The
full result goes to <out-dir>/parallel_probe.json and the readings, as one
JSON object, to the last line of standard output. It does not stand for
the smoke: `python3 chip_smoke.py` runs every path. Exits 2 without a GPU,
1 with fewer cards than --min-cards.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))


def readings(parallel: dict) -> dict:
    """Each rank's mesh readings: the held step's distances and the 2nd dropout step's host ms."""
    keys = ("loss_rel", "grad_rel_l2", "grad_rel_l2_encoder", "grad_rel_l2_rest", "params_updated_otherwise")
    out = {}
    for world, group in parallel["groups"].items():
        for r, rank in enumerate(group["ranks"]):
            for tag, mesh in rank.items():
                if tag == "ident":
                    continue
                row = {k: mesh["step"][k] for k in keys}
                if "dropout" in mesh:
                    row["dropout_step_ms"] = mesh["dropout"]["step_ms"]
                if "multimodal" in mesh:
                    row["multimodal"] = {k: mesh["multimodal"][k] for k in keys}
                out[f"{world} ranks {tag} rank {r}"] = row
    return out


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", type=Path, default=ROOT / "build" / "parallel_probe")
    ap.add_argument("--min-cards", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_parallel: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < args.min_cards:
        print(f"probe_parallel: {torch.cuda.device_count()} card(s), --min-cards {args.min_cards}", file=sys.stderr)
        return 1
    import chip_smoke as S

    dev, card, t0 = S.start(args.out_dir)
    phase = S.parallel_phase(dev)
    parallel = S.parallel_path(dev, args.out_dir, phase)
    result = dict(card=card, cards=torch.cuda.device_count(), readings=readings(parallel),
                  wall_s=time.perf_counter() - t0)
    (args.out_dir / "parallel_probe.json").write_text(json.dumps(dict(result, parallel=parallel), indent=1,
                                                                 default=str))
    S.log(card)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
